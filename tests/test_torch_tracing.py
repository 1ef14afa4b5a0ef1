"""The serving path's spans and counters (``utils.profiling``): nothing is
recorded, and ``record_function`` never entered, outside a profiler; a
profiler started on the main thread switches on the spans of a device
thread that was already running; a served batch of a small CPU Predictor
leaves one batch record; ``StageTimer``'s spans are such spans; device
stage times are read in stream order; ``profile_trace`` records the device
thread."""

import glob
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_detection import NPZ, _raw_config
from treedetection_tpu_torch.config import Config, prepare_config
from treedetection_tpu_torch.models.mask_rcnn import STAGES
from treedetection_tpu_torch.parallel import mesh
from treedetection_tpu_torch.prediction import Predictor
from treedetection_tpu_torch.utils import profiling

TIMEOUT_S = 60
PAD = 128


@pytest.fixture
def record_functions(monkeypatch):
    """Every ``record_function`` the spans enter, by name."""
    entered = []
    original = torch.profiler.record_function

    class Counted(original):
        def __init__(self, name, *args, **kwargs):
            entered.append(name)
            super().__init__(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", Counted)
    profiling.trace_reset()
    yield entered
    profiling.trace_reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_spans_record_nothing_outside_a_profiler(record_functions):
    assert not profiling.tracing()
    with profiling.span("sync.test") as s:
        pass
    assert s is None
    with profiling.trace_batch("test.forward") as record:
        with profiling.stage_marks(STAGES, "test", torch.device("cpu")) as m:
            pass
    assert record is None and m is None
    with profiling.span("test.timed", timed=True) as timed:
        pass
    assert timed.seconds >= 0.0
    assert record_functions == []
    assert profiling.trace_snapshot() == {"spans": {}, "counts": {},
                                          "batches": []}


def test_a_running_device_thread_is_traced_under_a_main_thread_profiler(
        record_functions):
    """The profiler is started on the main thread after the device thread
    is up: the process-wide flag reads True there, the thread-local one
    False, and the thread's spans and counters reach ``TRACE``."""
    thread = mesh.device_executor("cpu")
    thread.submit(lambda: None).result(TIMEOUT_S)

    def on_device():
        with profiling.span("test.device_span"):
            pass
        return (torch.autograd.profiler._is_profiler_enabled,
                torch._C._autograd._profiler_enabled(),
                threading.current_thread().name)

    with _cpu_profile():
        flags = thread.submit(on_device).result(TIMEOUT_S)
    assert flags[:2] == (True, False)
    assert flags[2].startswith("td-device-cpu")
    snap = profiling.trace_snapshot()
    assert snap["counts"] == {"test.device_span": 1}
    assert snap["spans"]["test.device_span"] > 0
    assert record_functions == ["test.device_span"]
    assert not profiling.tracing()


@pytest.fixture(scope="module", params=[1, 2], ids=["one_device",
                                                   "two_device_entries"])
def small_predictor(request, tmp_path_factory):
    """A small CPU Predictor (R50 at 256, batch 2) and a batch for it; over
    two device entries each runs a chunk of one tile on its own thread."""
    root = tmp_path_factory.mktemp("tracing")
    for sub in ("rgb", "nDSM"):
        (root / sub).mkdir()
    Config.reset()
    config, _ = prepare_config(_raw_config(
        str(root / "out"), devices=["cpu"] * request.param), str(root))
    pred = Predictor(config, str(NPZ))
    batch = np.random.default_rng(0).integers(
        0, 255, (pred.batch_size, PAD, PAD, 3), dtype=np.uint8)
    return pred, batch, request.param


def _serve(pred, batch):
    forward, _ = pred._get_forward(PAD)
    parts = pred._dispatch.submit(forward, batch).result(TIMEOUT_S)
    return [out for out, _ in parts]


def test_a_served_batch_leaves_one_batch_record(small_predictor,
                                                record_functions):
    pred, batch, entries = small_predictor
    off = _serve(pred, batch)
    assert record_functions == []
    assert profiling.trace_snapshot()["batches"] == []
    with _cpu_profile():
        on = _serve(pred, batch)
    snap = profiling.trace_snapshot()
    assert len(snap["batches"]) == 1
    record = snap["batches"][0]
    assert record["queue"] is not None and record["queue"] >= 0
    assert record["forward"] > 0
    assert record["syncs"] >= 1 and record["sync"] > 0
    assert record["syncs"] == sum(
        n for name, n in snap["counts"].items() if name.startswith("sync."))
    # two NMS calls (proposals, detections) per chunk, each checked once
    # at least; every chunk's spans count into the batch's record
    assert snap["counts"]["sync.nms"] >= 2 * entries
    assert snap["counts"]["mask_rcnn.rpn"] == entries
    want = {"predictor.forward", "predictor.pin", "predictor.h2d",
            "predictor.preprocess", "predictor.d2h"} | {
                f"mask_rcnn.{stage}" for stage in STAGES}
    assert want <= set(record["spans"])
    assert record["device_ms"] == {}
    # the chunks run side by side, each inside the batch's forward
    stages = sum(record["spans"][f"mask_rcnn.{s}"] for s in STAGES)
    assert stages < entries * record["forward"]
    # the spans change no output
    assert len(off) == len(on) == entries
    for chunk_off, chunk_on in zip(off, on):
        for a, b in zip(chunk_off, chunk_on):
            assert torch.equal(a, b)


def test_profile_trace_records_the_device_thread(tmp_path, record_functions):
    thread = mesh.device_executor("cpu")
    thread.submit(lambda: None).result(TIMEOUT_S)

    def on_device():
        with profiling.span("test.on_device"):
            torch.ones(8).sum()

    with profiling.profile_trace(str(tmp_path)):
        with profiling.span("test.on_main"):
            thread.submit(on_device).result(TIMEOUT_S)
    (path,) = glob.glob(str(tmp_path / "trace_*.json"))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    tids = {e["name"]: e["tid"] for e in events
            if e.get("cat") == "user_annotation"}
    assert {"test.on_device", "test.on_main"} <= set(tids)
    assert tids["test.on_device"] != tids["test.on_main"]


def test_stage_timer_spans_are_traced_spans(record_functions):
    """``StageTimer.span`` times with :class:`profiling.Span`: under a
    profiler its spans enter ``record_function`` and reach ``TRACE`` too."""
    timer = profiling.StageTimer()
    with timer.span("test.stage"):
        pass
    assert record_functions == []
    with _cpu_profile():
        with timer.span("test.stage"):
            pass
    assert set(timer.spans) == {"test.stage"}
    assert record_functions == ["test.stage"]
    assert profiling.trace_snapshot()["counts"] == {"test.stage": 1}


class _Event:
    """A stand-in for a CUDA event: passed or not, at a time in ms."""

    def __init__(self, ms, passed=True):
        self.ms, self.passed, self.waited = ms, passed, False

    def query(self):
        return self.passed

    def synchronize(self):
        self.waited = self.passed = True

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_device_stage_times_are_read_in_stream_order(record_functions):
    """A record's ``device_ms`` holds each timed stage from the previous
    mark; a read without waiting stops at the first record whose events
    have not passed, and the snapshot waits for the rest."""
    records = []
    for t0, passed in ((0.0, True), (100.0, False), (200.0, True)):
        record = profiling.BatchRecord(queue=0.0)
        events = record.claim_events()
        assert record.claim_events() is None     # one chunk's events
        events += [("start", _Event(t0)), ("rpn", _Event(t0 + 40.0)),
                   ("maskhead", _Event(t0 + 70.0, passed))]
        profiling.TRACE.finish(record)
        records.append(record)
    profiling.TRACE.read_pending(wait=False)
    assert records[0].device_ms == {"rpn": 40.0, "maskhead": 30.0}
    assert records[1].device_ms == records[2].device_ms == {}
    snap = profiling.trace_snapshot()
    assert [b["device_ms"] for b in snap["batches"]] == [
        {"rpn": 40.0, "maskhead": 30.0}] * 3
    assert records[1].events is None and not profiling.TRACE.pending
