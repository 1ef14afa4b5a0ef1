"""The kernel wrappers' launch counters under concurrent callers.

The crown filter calls the pairwise wrappers from several threads, and a
Predictor over several devices calls the ROI wrappers from one thread per
device; ``chip_smoke.py`` reads the counts to show that the main path went
through each kernel, so a lost increment would under-report it.  The C
calls are replaced by stubs, so the tests need no card.
"""

import sys
import threading
import types

import pytest
import torch

from treedetection_tpu_torch.ops.kernels import pairwise as k234
from treedetection_tpu_torch.ops.kernels import roi_align as k156

THREADS = 16
PER_THREAD = 2000


def _hammer(fn):
    """``fn`` THREADS x PER_THREAD times from THREADS threads at once, with
    the interpreter switching threads as often as it can."""
    start = threading.Barrier(THREADS)

    def work():
        start.wait()
        for _ in range(PER_THREAD):
            fn()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)


class _FakeStream:
    cuda_stream = 0


class _NoDevice:
    def __init__(self, device):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture()
def fake_card(monkeypatch):
    """The pairwise library's C entries as stubs returning success, and
    ``torch.cuda``'s device and stream lookups as no-ops on the CPU."""
    lib = types.SimpleNamespace(
        td_pairwise_boxes=lambda *a: 0,
        td_pairwise_relation_bits=lambda *a: 0,
        td_relation_row_counts=lambda *a: 0)
    monkeypatch.setattr(k234, "_get_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", _NoDevice)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _FakeStream())
    monkeypatch.setattr(k234, "launches", {m: 0 for m in k234.launches})


@pytest.mark.parametrize("mode,packed", [("dedupe", True),
                                         ("containment", True),
                                         ("iou", False)])
def test_relation_launches_counted_exactly_from_many_threads(fake_card, mode,
                                                             packed):
    a = torch.zeros((4, 5 if mode == "dedupe" else 4))
    out = torch.empty((4, 16), dtype=torch.uint8)
    _hammer(lambda: k234._launch_into(mode, a, a, out, 0.5, 0.3, packed))
    assert k234.launches[mode] == THREADS * PER_THREAD
    assert sum(k234.launches.values()) == THREADS * PER_THREAD


def test_pair_launches_counted_exactly_from_many_threads(fake_card):
    bits = torch.zeros((4, 4), dtype=torch.uint8)
    counts = torch.zeros(4, dtype=torch.int64)
    ends = torch.empty_like(counts)
    _hammer(lambda: k234._pair_ends_into(bits, 32, 0, True, counts, ends))
    assert k234.launches == {"iou": 0, "containment": 0, "dedupe": 0,
                             "pairs": THREADS * PER_THREAD}


@pytest.mark.parametrize("name", ["launches", "launches_patches",
                                  "launches_resident", "launches_geometry",
                                  "launches_exact_tail"])
def test_roi_launches_counted_exactly_from_many_threads(monkeypatch, name):
    monkeypatch.setattr(k156, name, 0)
    _hammer(lambda: k156._count(name))
    assert getattr(k156, name) == THREADS * PER_THREAD
