"""The kernel wrappers' launch counters under concurrent callers.

The crown filter calls the pairwise wrappers from several threads, and a
Predictor over several devices calls the ROI and attention wrappers from one
thread per device; ``chip_smoke.py`` and ``tools/trace_check.py`` read the
counts (``build.launch_counts``) to show that the main path went through
each kernel, so a lost increment would under-report it.  Each case drives
one counter through the wrapper that names it, with the libraries stubbed
at the one loader (``build.load``) and the tensors only claiming to lie on
the card, so the tests need no card.
"""

import sys
import threading
import types

import pytest
import torch

from treedetection_tpu_torch import build
from treedetection_tpu_torch.ops.kernels import pairwise as k234
from treedetection_tpu_torch.ops.kernels import relpos_attention as ra
from treedetection_tpu_torch.ops.kernels import roi_align as k156

THREADS = 16
PER_THREAD = 2000
# calls per thread of a whole ROI or attention wrapper, whose argument
# checks take up to a millisecond a call on the CPU
WRAPPER_CALLS = 250
CARD = torch.device("cuda", 0)


def _hammer(fn, per_thread=PER_THREAD):
    """``fn`` THREADS x ``per_thread`` times from THREADS threads at once,
    with the interpreter switching threads as often as it can."""
    start = threading.Barrier(THREADS)

    def work():
        start.wait()
        for _ in range(per_thread):
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


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so that a wrapper takes
    its launch path; what is computed from it is a plain CPU tensor."""
    __torch_function__ = torch._C._disabled_torch_function_impl

    @property
    def device(self):
        return CARD


def _card(t: torch.Tensor) -> torch.Tensor:
    return t.as_subclass(_OnCard)


def _stub(library):
    """The C entries of ``library`` as stubs returning success, each
    checking that it was given one argument per bound type."""
    def entry(name, argtypes):
        def call(*args):
            assert len(args) == len(argtypes), (name, len(args))
            return 0
        return call
    return types.SimpleNamespace(**{name: entry(name, argtypes) for
                                    name, argtypes in library.entries.items()})


@pytest.fixture()
def fake_card(monkeypatch):
    """Every library stubbed at ``build.load``; ``torch.cuda``'s device and
    stream lookups as no-ops and tensors made for the card made on the CPU;
    the counters reset before and after."""
    stubs = {name: _stub(lib) for name, lib in build.LIBRARIES.items()}
    monkeypatch.setattr(build, "load", lambda library: stubs[library.name])
    monkeypatch.setattr(torch.cuda, "device", _NoDevice)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _FakeStream())
    for factory in ("empty", "tensor"):
        made = getattr(torch, factory)
        monkeypatch.setattr(torch, factory, lambda *a, device=None, _f=made,
                            **k: _f(*a, **k))
    build.launch_counts(reset=True)
    yield
    build.launch_counts(reset=True)


def _assert_only(name, per_thread=PER_THREAD):
    assert build.launch_counts() == {name: THREADS * per_thread}


@pytest.mark.parametrize("mode,packed", [("dedupe", True),
                                         ("containment", True),
                                         ("iou", False)])
def test_relation_launches_counted_exactly_from_many_threads(fake_card, mode,
                                                             packed):
    a = torch.zeros((4, 5 if mode == "dedupe" else 4))
    out = torch.empty((4, 16), dtype=torch.uint8)
    _hammer(lambda: k234._launch_into(mode, _card(a), a, out, 0.5, 0.3,
                                      packed))
    _assert_only(mode)


def test_pair_launches_counted_exactly_from_many_threads(fake_card):
    bits = _card(torch.zeros((4, 4), dtype=torch.uint8))
    counts = torch.zeros(4, dtype=torch.int64)
    ends = torch.empty_like(counts)
    _hammer(lambda: k234._pair_ends_into(bits, 32, 0, True, counts, ends))
    _assert_only("pairs")


def test_pair_writes_counted_exactly_from_many_threads(fake_card):
    bits = _card(torch.zeros((4, 4), dtype=torch.uint8))
    ends = torch.ones(4, dtype=torch.int64)
    out = torch.empty((2, 4), dtype=torch.int32)
    _hammer(lambda: k234._pairs_into(bits, 32, 0, True, ends, out))
    _assert_only("pairs.write")


def _pool_call(name):
    """A call of the ROI wrapper that launches the kernel counted on
    ``name``: one box of a (48, 56) window at 7x7, float32, C = 8."""
    r, p = 7, 48
    ay, ax = _card(torch.zeros(1, r, p)), _card(torch.zeros(1, r, p + 8))
    idx = _card(torch.zeros(1, dtype=torch.int32))
    meta = _card(torch.zeros((1, 3), dtype=torch.int32))
    boxes = _card(torch.zeros((1, 4)))
    table = _card(torch.zeros((1, len(k156.TABLE_COLUMNS)),
                              dtype=torch.int64))
    if name == "k1":
        fcat = _card(torch.zeros(p, p + 8, 8))
        return lambda: k156.roi_pool_patches_flat(fcat, idx, idx, ay, ax, r)
    if name == "k5":
        level = _card(torch.zeros(p, p + 8, 8))
        return lambda: k156.roi_pool_patches([level], meta, ay, ax, r)
    if name == "k6":
        level = _card(torch.zeros(2 * p, 2 * (p + 8), 8))
        return lambda: k156.roi_pool_resident([level], meta, ay, ax, r, p,
                                              chunk=1, n_images=1)
    if name == "geometry":
        return lambda: k156.roi_geometry(boxes, table, 1, r, 2, p, True)
    fcat = _card(torch.zeros(p, p + 8, 8))
    out = _card(torch.zeros(1, r, r, 8))
    flag = _card(torch.ones(1, 1))
    top = _card(torch.zeros((1, 1), dtype=torch.int64))
    return lambda: k156.roi_exact_tail([fcat], True, table, boxes, flag, top,
                                       out, None, r, 2)


@pytest.mark.parametrize("name", ["k1", "k5", "k6", "geometry",
                                  "exact_tail"],
                         ids=["launches", "launches_patches",
                              "launches_resident", "launches_geometry",
                              "launches_exact_tail"])
def test_roi_launches_counted_exactly_from_many_threads(fake_card, name):
    _hammer(_pool_call(name), WRAPPER_CALLS)
    _assert_only(name, WRAPPER_CALLS)


@pytest.mark.parametrize("window", [2, 0], ids=["window", "global"])
def test_attention_launches_counted_exactly_from_many_threads(fake_card,
                                                              window):
    heads, d, side = 1, ra.HEAD_DIM, 2
    qkv = _card(torch.zeros((1, side, side, 3 * heads * d),
                            dtype=torch.bfloat16))
    bias = _card(torch.zeros(3 * heads * d, dtype=torch.bfloat16))
    rel = _card(torch.zeros((2 * side - 1, d), dtype=torch.bfloat16))
    _hammer(lambda: ra.relpos_attention(qkv, bias, rel, rel, heads, window),
            WRAPPER_CALLS)
    _assert_only("relpos.window" if window else "relpos.global",
                 WRAPPER_CALLS)
