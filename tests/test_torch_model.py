"""The port's model against the JAX package's, both on the CPU in float32.

Same weights on both sides: the committed trained R50 ``model_full.npz`` and
the synthetic detectron2 state dict of ``test_convert``, carried to the port
by ``from_flax_params``.  Inputs are made with numpy from a seed.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from treedetection_tpu_torch.models.convert import (  # noqa: E402
    from_flax_params, load_checkpoint)
from treedetection_tpu_torch.models.mask_rcnn import (  # noqa: E402
    MaskRCNN, MaskRCNNConfig)
from treedetection_tpu_torch.models.resnet import ResNetFPN  # noqa: E402

NPZ = Path(__file__).resolve().parents[1] / "example" / "data" / "model_full.npz"
PIXEL_MEAN = np.asarray([103.53, 116.28, 123.675], dtype=np.float32)


@pytest.fixture(scope="module")
def jax_npz_params():
    from treedetection_tpu.models.convert import load_checkpoint as jax_load
    return jax_load(str(NPZ), depth=50, scan=True, param_dtype=np.float32)


@pytest.fixture(scope="module")
def d2_models():
    """(jax model, jax params, port model) on the synthetic R50 weights."""
    from test_convert import _make_fake_d2_state_dict
    from treedetection_tpu.models import MaskRCNN as JaxMaskRCNN
    from treedetection_tpu.models import MaskRCNNConfig as JaxConfig
    from treedetection_tpu.models.convert import convert_detectron2_state_dict
    kw = dict(depth=50, input_size=128, rpn_pre_nms_topk=200,
              rpn_post_nms_topk=100, max_detections=20)
    params = convert_detectron2_state_dict(_make_fake_d2_state_dict(depth=50),
                                           depth=50)
    port = MaskRCNN(MaskRCNNConfig(**kw)).eval()
    port.load_state_dict(from_flax_params(params), strict=True)
    return JaxMaskRCNN(JaxConfig(bf16=False, **kw)), params, port


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def test_from_flax_params_tensor_by_tensor(jax_npz_params):
    """Every leaf of model_full.npz lands on its torch tensor, re-laid-out
    exactly (a pure permutation of float16 values widened to float32)."""
    sd = load_checkpoint(str(NPZ))
    model = MaskRCNN(MaskRCNNConfig(depth=50))
    model.load_state_dict(sd, strict=True)
    assert all(t.dtype == torch.float32 for t in sd.values())
    from treedetection_tpu.models.convert import restack_backbone
    flat = _flat(restack_backbone(jax_npz_params, scan=False)["params"])
    assert len(flat) == len(sd)
    bu = "backbone/bottom_up/"
    checks = {
        bu + "stem/conv/kernel": ("backbone.bottom_up.stem.conv.weight",
                                  lambda a: a.transpose(3, 2, 0, 1)),
        bu + "res4_5/conv2/conv/kernel": (
            "backbone.bottom_up.res4.5.conv2.conv.weight",
            lambda a: a.transpose(3, 2, 0, 1)),
        bu + "res3_2/conv1/norm/scale": (
            "backbone.bottom_up.res3.2.conv1.norm.scale", lambda a: a),
        "box_head/fc1/kernel": ("box_head.fc1.weight", lambda a: a.T),
        "mask_head/deconv/kernel": (
            "mask_head.deconv.weight",
            lambda a: a[::-1, ::-1].transpose(2, 3, 0, 1)),
        "rpn_head/anchor_deltas/bias": ("rpn_head.anchor_deltas.bias",
                                        lambda a: a),
    }
    for src, (dst, fn) in checks.items():
        np.testing.assert_array_equal(sd[dst].numpy(), fn(flat[src]))
    # every leaf: same multiset of values (a layout change, nothing else)
    for key, leaf in flat.items():
        tkey = key.replace("/", ".").replace("kernel", "weight")
        tkey = __import__("re").sub(r"(res\d)_(\d+)", r"\1.\2", tkey)
        assert np.array_equal(np.sort(sd[tkey].numpy().ravel()),
                              np.sort(np.asarray(leaf).ravel())), key


def test_from_flax_params_loads_r101():
    """The R101 tree (23 res4 blocks, scanned layout) converts and loads
    strictly, leaf for leaf."""
    from test_convert import _make_fake_d2_state_dict
    from treedetection_tpu.models.convert import convert_detectron2_state_dict
    params = convert_detectron2_state_dict(
        _make_fake_d2_state_dict(depth=101), depth=101)
    sd = from_flax_params(params)
    model = MaskRCNN(MaskRCNNConfig(depth=101))
    model.load_state_dict(sd, strict=True)
    assert len(model.backbone.bottom_up.res4) == 23
    w = params["params"]["backbone"]["bottom_up"]["res4_rest"]["block"][
        "conv2"]["conv"]["kernel"][21]                  # block 22 of res4
    np.testing.assert_array_equal(
        sd["backbone.bottom_up.res4.22.conv2.conv.weight"].numpy(),
        np.asarray(w).transpose(3, 2, 0, 1))


def test_resnet_fpn_levels_match_jax(jax_npz_params):
    """ResNetFPN on model_full.npz, P2..P6 at 128^2.  Tolerance 1e-4 of each
    level's peak: both sides run float32 convolutions that sum in different
    orders over 50 layers."""
    from treedetection_tpu.models.resnet import ResNetFPN as JaxResNetFPN
    rng = np.random.default_rng(3)
    x = (rng.integers(0, 255, (2, 128, 128, 3)).astype(np.float32)
         - PIXEL_MEAN) / np.asarray([57.375, 57.12, 58.395], np.float32)
    want = JaxResNetFPN(depth=50).apply(
        {"params": jax_npz_params["params"]["backbone"]}, jnp.asarray(x))
    net = ResNetFPN(depth=50).eval()
    sd = load_checkpoint(str(NPZ))
    net.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()
                         if k.startswith("backbone.")}, strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    for lvl, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, (lvl, g.shape, w.shape)
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-4 * max(1.0, np.abs(w).max()), (lvl + 2, err)


def _binary_iou(a, b):
    union = np.logical_or(a, b).sum()
    return np.logical_and(a, b).sum() / union if union else 1.0


def _compare_forward_with_jax(d2_models, monkeypatch):
    """Full forward at 128^2 on the synthetic R50, JAX running its Pallas
    pooler in interpret mode (with its exact tail and overflow counters):
    the test_oracle tolerances."""
    import functools
    from treedetection_tpu.models import mask_rcnn as jmr
    from treedetection_tpu.ops.roi_align import (
        multilevel_roi_align_batched as jax_pool)
    monkeypatch.setattr(jmr, "multilevel_roi_align_batched", functools.partial(
        jax_pool, pallas=True, force_interpret=True))
    jax_model, params, port = d2_models
    rng = np.random.default_rng(11)
    x = rng.integers(0, 255, (2, 128, 128, 3)).astype(np.float32) - PIXEL_MEAN
    want = jax.jit(lambda p, im: jax_model.apply(p, im))(params, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum() > 0, "no detections: the comparison is vacuous"
    np.testing.assert_array_equal(got.roi_overflow.numpy(),
                                  np.asarray(want.roi_overflow))
    np.testing.assert_array_equal(got.prop_overflow.numpy(),
                                  np.asarray(want.prop_overflow))
    for b in range(x.shape[0]):
        nv = int(valid[b].sum())
        gb, wb = got.boxes[b, :nv].numpy(), np.asarray(want.boxes[b, :nv])
        assert np.abs(gb - wb).max(initial=0) < 1e-3 * 128 / 128
        gs, ws = got.scores[b, :nv].numpy(), np.asarray(want.scores[b, :nv])
        assert np.abs(gs - ws).max(initial=0) < 1e-4
        gm = got.masks[b, :nv].numpy().astype(np.float32) / 255.0
        wm = np.asarray(want.masks[b, :nv]).astype(np.float32) / 255.0
        assert np.abs(gm - wm).max(initial=0) < 0.02
        for d in range(nv):
            assert _binary_iou(gm[d] > 0.5, wm[d] > 0.5) >= 0.99, (b, d)
    return got


ROI_LAYOUT_VARS = ("TD_ROI_FLAT", "TD_ROI_RESIDENT", "TD_ROI_SMALL",
                   "TD_ROI_LARGE_FRAC", "TD_ROI_EXACT_FRAC")


def test_mask_rcnn_matches_jax(d2_models, monkeypatch):
    """The default layout (one flat buffer, K1's plain version here)."""
    for name in ROI_LAYOUT_VARS:
        monkeypatch.delenv(name, raising=False)
    _compare_forward_with_jax(d2_models, monkeypatch)


@pytest.mark.parametrize("layout,env", [
    ("levels", {"TD_ROI_FLAT": "0"}),
    ("resident", {"TD_ROI_RESIDENT": "1"}),
    ("small_class", {"TD_ROI_FLAT": "0", "TD_ROI_SMALL": "16",
                     "TD_ROI_LARGE_FRAC": "0.5"})])
def test_mask_rcnn_layouts_match_jax(d2_models, monkeypatch, layout, env):
    """The same forward with the pooler in its other layouts (per-level
    buffers through K5, image-resident sections through K6, and the small
    patch class on), both packages under the same variables: the same
    tolerances, and the port went through that layout's pooler."""
    from treedetection_tpu_torch.ops import roi_align as port_pool
    for name in ROI_LAYOUT_VARS:
        monkeypatch.delenv(name, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    calls = {"roi_pool_patches": 0, "roi_pool_resident": 0,
             "roi_pool_patches_flat": 0}
    for name in calls:
        def counted(*args, _real=getattr(port_pool, name), _name=name):
            calls[_name] += 1
            return _real(*args)
        monkeypatch.setattr(port_pool, name, counted)
    _compare_forward_with_jax(d2_models, monkeypatch)
    assert calls["roi_pool_patches_flat"] == 0
    if layout == "resident":
        assert calls["roi_pool_resident"] == 2
    else:
        assert calls["roi_pool_patches"] == (2 if layout == "levels" else 4)
        assert calls["roi_pool_resident"] == 0


def test_mask_rcnn_plain_pool_matches_default(d2_models):
    """Passing the plain patch pooler explicitly gives the same output as
    the default wrapper (which takes the plain version on the CPU)."""
    from treedetection_tpu_torch.ops.kernels.roi_align import (
        roi_pool_patches_flat_reference)
    _, _, port = d2_models
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 128, 128, 3)).astype(np.float32) * 50)
    with torch.no_grad():
        a = port(x)
        b = port(x, roi_pool=roi_pool_patches_flat_reference)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
