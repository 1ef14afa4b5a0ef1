"""The kernel wrappers' launch counters under concurrent callers.

The crown filter calls the pairwise wrappers from several threads, and a
Predictor over several devices calls the ROI, attention and frozen-norm
wrappers from one thread per device; ``chip_smoke.py`` and
``tools/trace_check.py`` read the counts (``build.launch_counts``) to show
that the main path went through each kernel, so a lost increment would
under-report it.  Each case drives one counter through the wrapper that
names it, with the libraries stubbed at the one loader (``build.load``) and
the tensors only claiming to lie on the card, so the tests need no card.
The backbone's cases run whole forwards whose every tensor claims to lie on
the card, and count where the frozen-norm kernel engages.
"""

import sys
import threading
import types

import pytest
import torch

from treedetection_tpu_torch import build
from treedetection_tpu_torch.models import resnet
from treedetection_tpu_torch.models.resnet import (FrozenBN, ResNetFPN,
                                                   frozen_norm_launches)
from treedetection_tpu_torch.models.mvit import MViTBackbone
from treedetection_tpu_torch.models.vit import ViTDetBackbone
from treedetection_tpu_torch.ops.kernels import frozen_norm as fn
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
    for factory in ("empty", "tensor", "zeros"):
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


@pytest.mark.parametrize("windows", [(4, 2), (0, 0)],
                         ids=["pooled_window", "pooled_global"])
def test_pooled_attention_launches_counted_exactly_from_many_threads(
        fake_card, windows):
    d = ra.POOLED_HEAD_DIM
    q = _card(torch.zeros((1, 4, 4, d), dtype=torch.bfloat16))
    kv = _card(torch.zeros((1, 2, 2, d), dtype=torch.bfloat16))
    rows = ra.table_rows(windows[0] or 4, windows[1] or 2)
    rel = _card(torch.zeros((rows, d), dtype=torch.bfloat16))
    _hammer(lambda: ra.pooled_attention(q, kv, kv, rel, rel, 1, *windows),
            WRAPPER_CALLS)
    _assert_only("relpos.pooled_window" if windows[0]
                 else "relpos.pooled_global", WRAPPER_CALLS)


def test_mvit_forward_on_the_card_launches_the_pooled_kernel_a_block(
        fake_card):
    """A four-stage MViT at heads of 96 (stage 2 windowed, the others
    global): one pooled launch a block, of its kind, and nothing else."""
    model = _on_card(MViTBackbone(
        img_size=64, embed_dim=96, depth=4, num_heads=1,
        last_block_indexes=(0, 1, 2, 3), window=8, kv_stride=4,
        pretrain_size=64).eval().to(torch.bfloat16))
    for m in model.modules():      # the tables at the rows read, too
        for k, b in m._buffers.items():
            m._buffers[k] = b.as_subclass(_Card)
    with torch.no_grad():
        model(_image(64, torch.bfloat16).as_subclass(_Card))
    assert build.launch_counts() == {"relpos.pooled_window": 1,
                                     "relpos.pooled_global": 3}


def _norm_call(form):
    """A call of the frozen-norm wrapper that launches its kernel in
    ``form``: a (1, 8, 2, 2) bf16 map in channels_last memory."""
    def card_map():
        return _card(torch.zeros((1, 8, 2, 2), dtype=torch.bfloat16).to(
            memory_format=torch.channels_last))
    y, sc = card_map(), card_map()
    s = _card(torch.ones(8, dtype=torch.bfloat16))
    if form == "relu":
        return lambda: fn.frozen_norm_relu(y, s, s)
    if form == "tail":
        return lambda: fn.frozen_norm_tail(y, s, s, sc)
    return lambda: fn.frozen_norm_tail(y, s, s, sc, s, s)


@pytest.mark.parametrize("form", ["relu", "tail", "tail_projected"])
def test_frozen_norm_launches_counted_exactly_from_many_threads(fake_card,
                                                                form):
    _hammer(_norm_call(form), WRAPPER_CALLS)
    _assert_only("frozen_norm" if form == "relu" else "frozen_norm.tail",
                 WRAPPER_CALLS)


def _off_boundary(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values at its strides, one element past a 16-byte
    boundary."""
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype)
    m = buf.as_strided(t.shape, t.stride(), 1)
    m.copy_(t)
    return m


@pytest.mark.parametrize("case,match", [
    ("bf16_c12", "multiple of 8"), ("fp32_c3", "multiple of 4"),
    ("y", "y must start"), ("scale", "scale must start"),
    ("shortcut", "shortcut must start"),
    ("shortcut_scale", "shortcut_scale must start")])
def test_frozen_norm_refuses_what_its_vectors_do_not_take(fake_card, case,
                                                          match):
    """A channel count that the kernel's 16-byte vectors do not fill, or a
    tensor off a 16-byte boundary: the wrapper raises and launches
    nothing (no ResNet layer has either)."""
    dtype = torch.float32 if case == "fp32_c3" else torch.bfloat16
    c = {"bf16_c12": 12, "fp32_c3": 3}.get(case, 8)

    def tensor(name, shape):
        t = torch.ones(shape, dtype=dtype)
        if len(shape) == 4:
            t = t.contiguous(memory_format=torch.channels_last)
        return _card(_off_boundary(t) if name == case else t)
    y, sc = tensor("y", (1, c, 2, 2)), tensor("shortcut", (1, c, 2, 2))
    s, b = tensor("scale", (c,)), tensor("bias", (c,))
    ss, sb = tensor("shortcut_scale", (c,)), tensor("shortcut_bias", (c,))
    with pytest.raises(ValueError, match=match):
        if case in ("y", "scale"):
            fn.frozen_norm_relu(y, s, b)
        else:
            fn.frozen_norm_tail(y, s, b, sc, ss, sb)
    assert build.launch_counts() == {}


class _Card(torch.Tensor):
    """A CPU tensor that says it lies on the card, as does every tensor
    computed from it: a whole forward takes the card's paths."""

    @property
    def device(self):
        return CARD


def _on_card(model: torch.nn.Module) -> torch.nn.Module:
    """``model`` with every parameter a :class:`_Card` tensor."""
    for m in model.modules():
        for k, p in m._parameters.items():
            if p is not None:
                m._parameters[k] = torch.nn.Parameter(
                    p.detach().as_subclass(_Card),
                    requires_grad=p.requires_grad)
    return model


def _image(size=32, dtype=torch.float32):
    gen = torch.Generator().manual_seed(0)
    return torch.randn((1, size, size, 3), generator=gen).to(dtype)


@pytest.mark.parametrize("depth,relu,tail", [(50, 33, 16), (101, 67, 33)])
def test_resnet_forward_on_the_card_launches_the_norm_kernel(fake_card,
                                                             depth, relu,
                                                             tail):
    """One launch of the ReLU form for the stem and each conv1 and conv2,
    one of the tail form for each bottleneck: 67 + 33 for R101, 33 + 16 for
    R50, as ``frozen_norm_launches`` says, and nothing else."""
    want = {"frozen_norm": relu, "frozen_norm.tail": tail}
    assert frozen_norm_launches(depth) == want
    model = _on_card(ResNetFPN(depth=depth).eval())
    with torch.no_grad():
        model(_image().as_subclass(_Card))
    assert build.launch_counts() == want


def test_vitdet_forward_on_the_card_launches_no_norm_kernel(fake_card):
    model = _on_card(ViTDetBackbone(
        img_size=64, dim=64, depth=2, num_heads=1, window=2,
        global_blocks=(1,)).eval().to(torch.bfloat16))
    with torch.no_grad():
        model(_image(64, torch.bfloat16).as_subclass(_Card))
    assert build.launch_counts() == {"relpos.window": 1, "relpos.global": 1}


@pytest.mark.parametrize("case", ["grad", "cpu", "batch_norm"])
def test_resnet_takes_the_plain_path_off_the_card_and_with_gradients(
        fake_card, case):
    """Gradients recorded (frozen fine-tuning), a tensor on the CPU, or
    batch norm (training from scratch): no launch, and the output of the
    unfused operations."""
    torch.manual_seed(0)
    norm = "batch" if case == "batch_norm" else "frozen"
    model = ResNetFPN(depth=50, norm=norm)
    with torch.no_grad():      # batch norm's statistics want 2 x 2 at C5
        plain = model(_image(64))
    card = case != "cpu"
    if card:
        _on_card(model)
    x = _image(64).as_subclass(_Card) if card else _image(64)
    with torch.set_grad_enabled(case == "grad"):
        out = model(x)
    assert build.launch_counts() == {}
    for a, b in zip(out, plain):
        assert torch.equal(a.as_subclass(torch.Tensor), b)


def test_resnet_fused_forward_equals_the_plain_path_on_the_cpu(monkeypatch):
    """Where the kernel engages, each conv's output goes to the wrapper with
    the norms it belongs to: on the CPU the wrappers' plain versions make
    the forward bit-equal to the unfused one."""
    torch.manual_seed(0)
    model = ResNetFPN(depth=50).eval()
    gen = torch.Generator().manual_seed(1)
    for m in model.modules():      # norms that are not the identity
        if isinstance(m, FrozenBN):
            m.scale.data = torch.rand(m.scale.shape, generator=gen) + 0.5
            m.bias.data = torch.randn(m.bias.shape, generator=gen)
    with torch.no_grad():
        plain = model(_image())
        monkeypatch.setattr(resnet, "_fused", lambda module, x: True)
        fused = model(_image())
    for a, b in zip(fused, plain):
        assert torch.equal(a, b)


def test_backbones_name_the_libraries_they_launch():
    assert fn.LIBRARY in ResNetFPN.libraries
    assert fn.LIBRARY not in ViTDetBackbone.libraries
    assert ra.LIBRARY not in ResNetFPN.libraries
