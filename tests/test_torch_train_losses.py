"""The port's training losses and their pieces against the JAX package's
(``treedetection_tpu/train/losses.py``) on the CPU, at
``tests/test_train.py``'s TINY size: R50, 128^2, 64/32 proposals, fp32,
exact top-k, the same parameters (JAX's ``create_model`` carried across
with ``from_flax_params``) and the same batch.

Tolerances:
- discrete results (anchor labels and matches, fg/bg, best GT) identical;
- ``encode_deltas``, ``roi_align`` and the differentiable multilevel pooler
  (values and gradients) within 1e-5 of the largest magnitude;
- the five loss terms within 1e-4 relative, on the JAX proposals (stage by
  stage) and for the whole call, in both norm modes and with and without
  remat; the running statistics within 1e-5 of the largest.

The gradients are held in ``tests/test_torch_train_grads.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_train import TINY, make_batch
from treedetection_tpu.models.mask_rcnn import create_model as jax_create_model
from treedetection_tpu.models.anchors import pyramid_anchors as jax_anchors
from treedetection_tpu.models.rpn import generate_proposals
from treedetection_tpu.ops import boxes as jax_boxes
from treedetection_tpu.train import losses as jl

from treedetection_tpu_torch.models import resnet as port_resnet
from treedetection_tpu_torch.models.convert import from_flax_params
from treedetection_tpu_torch.models.mask_rcnn import MaskRCNN, MaskRCNNConfig
from treedetection_tpu_torch.models.rpn import Proposals
from treedetection_tpu_torch.ops import boxes as port_boxes
from treedetection_tpu_torch.train import losses as tl

jax_roi = importlib.import_module("treedetection_tpu.ops.roi_align")
port_roi = importlib.import_module("treedetection_tpu_torch.ops.roi_align")

TERMS = ("rpn_objectness", "rpn_regression", "cls", "box_reg", "mask")
KEYS = ("image", "boxes", "masks", "valid")


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two intra-op threads for the module: under pytest-xdist several
    workers share the cores, each with JAX's thread pool too, and torch's
    default of one thread per core oversubscribes them."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def port_cfg(**over) -> MaskRCNNConfig:
    kw = dict(depth=50, input_size=TINY.input_size,
              rpn_pre_nms_topk=TINY.rpn_pre_nms_topk,
              rpn_post_nms_topk=TINY.rpn_post_nms_topk,
              max_detections=TINY.max_detections)
    kw.update(over)
    return MaskRCNNConfig(**kw)


def port_model(params, **over) -> MaskRCNN:
    model = MaskRCNN(port_cfg(**over))
    model.load_state_dict(from_flax_params(jax.device_get(params)),
                          strict=True)
    return model


def torch_batch(b):
    return [torch.from_numpy(b[k]) for k in KEYS]


@pytest.fixture(scope="module")
def jax_runs():
    """norm -> (JAX model, params, batch, total, parts, batch_stats,
    proposals (B, K, 4), proposal scores), from one jitted call per norm."""
    import dataclasses
    out = {}
    batch = make_batch()
    args = [jnp.asarray(batch[k]) for k in KEYS]
    anchors = [jnp.asarray(a) for a in jax_anchors(TINY.input_size)]
    for norm in ("frozen", "batch"):
        model, params = jax_create_model(dataclasses.replace(TINY, norm=norm))

        def run(p, model=model, norm=norm):
            total, (parts, mut) = jl.mask_rcnn_losses(
                model, p, *args, jax.random.PRNGKey(0), return_state=True)
            res = model.apply(p, args[0], method=jl._forward_features,
                              mutable=["batch_stats"] if norm == "batch"
                              else False)
            _, logits, deltas = res[0] if norm == "batch" else res
            props = jax.vmap(lambda lg, dl: generate_proposals(
                lg, dl, anchors, TINY.input_size, TINY.rpn_pre_nms_topk,
                TINY.rpn_post_nms_topk, TINY.rpn_nms_threshold))(logits,
                                                                 deltas)
            return total, parts, mut, props

        total, parts, mut, props = jax.jit(run)(params)
        out[norm] = (model, params, batch, float(total),
                     {k: float(v) for k, v in parts.items()},
                     jax.device_get(mut.get("batch_stats", {})),
                     np.asarray(props.boxes), np.asarray(props.scores))
    return out


def _random_boxes(rng, n, size, min_wh=1.0, max_wh=None):
    max_wh = max_wh or size
    xy = rng.uniform(-0.1 * size, size, (n, 2))
    wh = rng.uniform(min_wh, max_wh, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


# --- pieces --------------------------------------------------------------------

def test_smooth_l1_matches_jax():
    x = np.linspace(-3, 3, 61).astype(np.float32)
    for beta in (0.0, 1.0, 0.1):
        np.testing.assert_allclose(
            tl.smooth_l1(torch.from_numpy(x), beta).numpy(),
            np.asarray(jl.smooth_l1(jnp.asarray(x), beta)), rtol=1e-6,
            atol=1e-7)


def test_encode_deltas_matches_jax():
    rng = np.random.default_rng(3)
    src = _random_boxes(rng, 500, 128.0)
    tgt = _random_boxes(rng, 500, 128.0)
    src[:5, 2] = src[:5, 0]                 # zero width: the eps clamp
    tgt[5:10, 3] = tgt[5:10, 1]
    for weights in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        ref = np.asarray(jax_boxes.encode_deltas(
            jnp.asarray(src), jnp.asarray(tgt), weights))
        got = port_boxes.encode_deltas(torch.from_numpy(src),
                                       torch.from_numpy(tgt), weights)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


def _gt(rng, b, g, size, n_valid):
    boxes = np.stack([_random_boxes(rng, g, size, 4.0, 60.0)
                      for _ in range(b)])
    valid = np.zeros((b, g), dtype=bool)
    for i, n in enumerate(n_valid):
        valid[i, :n] = True
    masks = (rng.random((b, g, size // 4, size // 4)) > 0.5).astype(
        np.float32)
    return boxes, masks, valid


def test_assign_anchors_identical():
    rng = np.random.default_rng(4)
    anchors = np.concatenate(jax_anchors(128))
    boxes, masks, valid = _gt(rng, 3, 6, 128, (6, 2, 0))
    boxes[0, 0] = anchors[100]              # an exact anchor: IoU 1, ties
    ref = jax.vmap(lambda bx, m, v: jl.assign_anchors(
        jnp.asarray(anchors), jl.GroundTruth(bx, m, v)))(
            jnp.asarray(boxes), jnp.asarray(masks), jnp.asarray(valid))
    got = tl.assign_anchors(torch.from_numpy(anchors), tl.GroundTruth(
        torch.from_numpy(boxes), torch.from_numpy(masks),
        torch.from_numpy(valid)))
    assert np.array_equal(got[0].numpy(), np.asarray(ref[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert (got[0].numpy() == 1).sum() >= 8   # forced and IoU positives


def test_assign_proposals_identical():
    rng = np.random.default_rng(5)
    props = np.stack([_random_boxes(rng, 80, 128.0, 4.0, 60.0)
                      for _ in range(3)])
    boxes, masks, valid = _gt(rng, 3, 6, 128, (6, 3, 0))
    props[0, :6] = boxes[0]                  # GT boxes appended: IoU 1
    pvalid = rng.random((3, 80)) > 0.2
    ref = jax.vmap(lambda p, pv, bx, m, v: jl.assign_proposals(
        p, pv, jl.GroundTruth(bx, m, v)))(
            *(jnp.asarray(a) for a in (props, pvalid, boxes, masks, valid)))
    got = tl.assign_proposals(
        torch.from_numpy(props), torch.from_numpy(pvalid), tl.GroundTruth(
            torch.from_numpy(boxes), torch.from_numpy(masks),
            torch.from_numpy(valid)))
    for a, b in zip(got[:3], ref[:3]):
        assert np.array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]),
                               rtol=1e-6, atol=1e-7)
    assert got[0].sum() > 0 and got[1].sum() > 0


def test_roi_align_matches_jax():
    """The single-level gather ROIAlign, one map for all boxes and one map
    per box (the mask loss's GT crops), boxes past every edge included."""
    rng = np.random.default_rng(6)
    boxes = _random_boxes(rng, 60, 40.0, 0.5, 30.0)
    fmap = rng.standard_normal((32, 32, 5)).astype(np.float32)
    ref = np.asarray(jax_roi.roi_align(jnp.asarray(fmap), jnp.asarray(boxes),
                                       7, 0.5, 2))
    got = port_roi.roi_align(torch.from_numpy(fmap), torch.from_numpy(boxes),
                             7, 0.5, 2).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    maps = (rng.random((60, 32, 32)) > 0.5).astype(np.float32)
    ref = np.asarray(jax.jit(jax.vmap(lambda m, b: jax_roi.roi_align(
        m[:, :, None], b[None], 28, 1.0, 2)[0, :, :, 0]))(
            jnp.asarray(maps), jnp.asarray(boxes)))
    got = port_roi.roi_align(torch.from_numpy(maps)[..., None],
                             torch.from_numpy(boxes), 28, 1.0, 2)[..., 0]
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def _pooler_inputs():
    """Four levels of a 512^2 image (C=8) and boxes on every level: crowns,
    boxes past the edges, and 24 elongated ones that outspan the 48-row
    window (more than FALLBACK_BUDGET, so some stay truncated)."""
    rng = np.random.default_rng(7)
    fmaps = [rng.standard_normal((512 // s, 512 // s, 8)).astype(np.float32)
             for s in (4, 8, 16, 32)]
    boxes = np.concatenate([
        _random_boxes(rng, 150, 512.0, 4.0, 500.0),
        np.array([[5.0, 40.0 + i, 470.0, 52.0 + i] for i in range(24)],
                 dtype=np.float32)])
    return fmaps, boxes


@pytest.mark.parametrize("resolution", [7, 14])
def test_differentiable_pooler_matches_jax(resolution):
    """``multilevel_roi_align(differentiable=True)`` against the JAX
    function with ``pallas=False``: values, the truncated count, and the
    gradient of every level under a random cotangent."""
    fmaps, boxes = _pooler_inputs()
    strides = (4, 8, 16, 32)
    jf = [jnp.asarray(f) for f in fmaps]

    def pool(fs):
        return jax_roi.multilevel_roi_align(
            fs, jnp.asarray(boxes), resolution, strides, pallas=False,
            return_overflow=True)

    ref, ref_over = jax.jit(pool)(jf)
    cot = np.random.default_rng(8).standard_normal(ref.shape).astype(
        np.float32)
    ref_g = jax.jit(jax.grad(lambda fs: (pool(fs)[0] * cot).sum()))(jf)
    tf = [torch.from_numpy(f).requires_grad_() for f in fmaps]
    got, over = port_roi.multilevel_roi_align(
        tf, torch.from_numpy(boxes), resolution, strides,
        return_overflow=True, differentiable=True)
    (got * torch.from_numpy(cot)).sum().backward()
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    assert int(over) == int(ref_over) > 0
    for f, g in zip(tf, ref_g):
        g = np.asarray(g)
        assert np.abs(g).max() > 0
        np.testing.assert_allclose(f.grad.numpy(), g, rtol=0,
                                   atol=1e-5 * np.abs(g).max())


def test_differentiable_pooler_keeps_no_windows():
    """Autograd keeps the window indices and the hats, not the (K, 48, 48,
    C) windows: no floating tensor as large as one window is saved."""
    fmaps, boxes = _pooler_inputs()
    c = 64
    fmaps = [torch.from_numpy(np.repeat(f, c // 8, axis=-1)).requires_grad_()
             for f in fmaps]
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        port_roi.multilevel_roi_align(fmaps, torch.from_numpy(boxes), 7,
                                      (4, 8, 16, 32), differentiable=True)
    window = port_roi.PATCH * port_roi.PATCH * c
    big = [tuple(t.shape) for t in saved
           if t.is_floating_point() and t.numel() >= window]
    # the gather fix-up keeps its (M, R, R, S, S) corner weights: M=16 boxes
    assert all(s[0] <= port_roi.FALLBACK_BUDGET and len(s) > 4
               for s in big), big


# --- the loss terms --------------------------------------------------------------

@pytest.mark.parametrize("norm", ["frozen", "batch"])
@pytest.mark.parametrize("remat", [False, True], ids=["noremat", "remat"])
def test_loss_terms_match_jax(jax_runs, norm, remat):
    """The whole call: the five terms within 1e-4 relative; with batch norm
    the running statistics after the step within 1e-5 of the largest."""
    _, params, batch, total, parts, stats, _, _ = jax_runs[norm]
    model = port_model(params, norm=norm, remat=remat)
    t, (got, state) = tl.mask_rcnn_losses(model, *torch_batch(batch),
                                          return_state=True)
    t.backward()       # remat recomputes here, outside the collector
    for k in TERMS:
        assert float(got[k]) == pytest.approx(parts[k], rel=1e-4), k
    assert float(t) == pytest.approx(total, rel=1e-4)
    if norm == "frozen":
        assert state == {}
        return
    ref = from_flax_params({"params": {}, "batch_stats": stats})
    assert set(state) == set(ref) and len(ref) == 53 * 2
    for k, v in ref.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5 * max(float(v.abs().max()), 1))


def test_running_stats_equal_with_remat_on_and_off(jax_runs):
    """Remat recomputes every block in the backward pass; the statistics
    move once per step all the same, bit for bit."""
    params, batch = jax_runs["batch"][1], jax_runs["batch"][2]
    states = []
    for remat in (False, True):
        model = port_model(params, norm="batch", remat=remat)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        t, (_, state) = tl.mask_rcnn_losses(model, *torch_batch(batch),
                                            return_state=True)
        t.backward()
        assert all(torch.equal(v, model.state_dict()[k])
                   for k, v in before.items())   # buffers untouched
        states.append(state)
    assert not port_resnet._STATS
    assert states[0].keys() == states[1].keys()
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])


@pytest.mark.parametrize("norm", ["frozen", "batch"])
def test_loss_terms_on_jax_proposals(jax_runs, norm, monkeypatch):
    """Stage by stage: JAX's proposals fed to the port's heads, so that a
    near-tie in proposal selection can neither hide nor fake a difference."""
    _, params, batch, _, parts, _, boxes, scores = jax_runs[norm]
    monkeypatch.setattr(tl, "generate_proposals", lambda *a, **k: Proposals(
        boxes=torch.from_numpy(boxes), scores=torch.from_numpy(scores)))
    model = port_model(params, norm=norm)
    _, got = tl.mask_rcnn_losses(model, *torch_batch(batch))
    for k in TERMS:
        assert float(got[k]) == pytest.approx(parts[k], rel=1e-4), k
