"""The readers of the program's batch records
(``treedetection_tpu_torch.utils.profiling.trace_snapshot``): medians over
a fabricated snapshot, None over an empty one and where the program has no
such records."""

from __future__ import annotations

import sys
import types

import pytest

from harness import metric_reader

SPAN_READERS = ("forward_host_ms", "queue_ms", "sync_wait_ms",
                "syncs_per_batch", "rpn_ms.served", "heads_ms.served")


def _batch(queue, forward, syncs, sync, rpn, heads):
    device_ms = {} if rpn is None else {"rpn": rpn, "maskhead": heads}
    return {"queue": queue, "forward": forward, "syncs": syncs,
            "sync": sync, "spans": {}, "device_ms": device_ms}


SNAPSHOT = {"spans": {}, "counts": {}, "batches": [
    _batch(None, 0.070, 30, 0.004, None, None),     # the first, untimed
    _batch(0.060, 0.072, 31, 0.006, 40.0, 30.0),
    _batch(0.064, 0.068, 29, 0.005, 42.0, 28.0),
    _batch(0.062, 0.074, 30, 0.003, 41.0, 29.0),
]}


def test_span_readers_take_the_median_of_the_batch_records(monkeypatch):
    from treedetection_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "trace_snapshot", lambda: SNAPSHOT)
    got = {name: metric_reader(name)({}) for name in SPAN_READERS}
    assert got == {
        "forward_host_ms": pytest.approx(71.0),
        "queue_ms": pytest.approx(62.0),
        "sync_wait_ms": pytest.approx(4.5),
        "syncs_per_batch": 30.0,
        "rpn_ms.served": 41.0,
        "heads_ms.served": 29.0}


def test_span_readers_read_none_without_records(monkeypatch):
    from treedetection_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "trace_snapshot",
                        lambda: {"spans": {}, "counts": {}, "batches": []})
    for name in SPAN_READERS:
        assert metric_reader(name)({}) is None
    # batches on the CPU carry no device stage times
    monkeypatch.setattr(profiling, "trace_snapshot", lambda: {
        "spans": {}, "counts": {},
        "batches": [_batch(0.01, 0.02, 3, 0.001, None, None)]})
    assert metric_reader("rpn_ms.served")({}) is None
    assert metric_reader("heads_ms.served")({}) is None


def test_span_readers_read_none_from_a_program_without_them(monkeypatch):
    """A program whose profiling module has no ``trace_snapshot`` (one
    that predates the batch records) gives nothing to read, and no
    error."""
    bare = types.ModuleType("treedetection_tpu_torch.utils.profiling")
    monkeypatch.setitem(sys.modules, "treedetection_tpu_torch.utils.profiling",
                        bare)
    for name in SPAN_READERS:
        assert metric_reader(name)({}) is None
