"""Both packages in bfloat16, the production dtype, on the trained
``example/data/model_full.npz`` (R50) at 256^2, on the CPU, stage by stage
on shared inputs.  The port runs as it serves (the module moved to
bfloat16) and as it trains (``MaskRCNNConfig.bf16``: float32 parameters,
bfloat16 compute); JAX with ``bf16=True``.

Tolerances, each against the largest magnitude of the JAX output (a bf16
ulp is 2^-8 of it; the measured differences are 2-3 ulps, from another
summation order):
- the backbone levels P2..P6: 2e-2 (measured <= 5.3e-3);
- the RPN logits and deltas on JAX's levels: 2e-2 (<= 7.5e-3);
- the box head (class logits, deltas) and the mask head on the same pooled
  features: 2e-2 (<= 6.9e-3);
- the five loss terms of one batch, relative: 2e-2 (<= 3.3e-3);
- detections of the whole forward (JAX's Pallas pooler in interpret mode):
  a near tie may flip a detection or its rank, so each detection scoring at
  least 0.1 above the threshold must have a partner in the other package
  with IoU >= 0.8 and a score within 0.05.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_losses import torch_threads  # noqa: F401 (a fixture)
from treedetection_tpu.models.convert import load_checkpoint as jax_load
from treedetection_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from treedetection_tpu.models.mask_rcnn import MaskRCNNConfig as JaxConfig
from treedetection_tpu.models.resnet import ResNetFPN as JaxResNetFPN
from treedetection_tpu.models.roi_heads import BoxHead, MaskHead
from treedetection_tpu.models.rpn import RPNHead
from treedetection_tpu.train import losses as jl

from treedetection_tpu_torch.models.convert import load_checkpoint
from treedetection_tpu_torch.models.mask_rcnn import MaskRCNN, MaskRCNNConfig
from treedetection_tpu_torch.train import losses as tl

NPZ = Path(__file__).resolve().parents[1] / "example" / "data" / "model_full.npz"
SIZE = 256
BF = jnp.bfloat16
TOL = 2e-2
KW = dict(depth=50, input_size=SIZE, rpn_pre_nms_topk=200,
          rpn_post_nms_topk=100, max_detections=20)


def crown_scene(seed: int, n: int = 2, crowns: int = 12):
    """Normalized (BGR, caffe means, torchvision std) images of dark crown
    discs on lighter ground, with their boxes and masks at SIZE/4."""
    rng = np.random.default_rng(seed)
    img = rng.normal([150, 160, 120], 12, (n, SIZE, SIZE, 3))
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    my, mx = np.mgrid[0:SIZE // 4, 0:SIZE // 4] * 4 + 2
    boxes = np.zeros((n, crowns, 4), np.float32)
    masks = np.zeros((n, crowns, SIZE // 4, SIZE // 4), np.float32)
    for b in range(n):
        for k in range(crowns):
            cy, cx = rng.uniform(20, SIZE - 20, 2)
            r = rng.uniform(8, 20)
            d2 = ((yy - cy) ** 2 + (xx - cx) ** 2) / r ** 2
            inside = d2 < 1
            img[b][inside] *= (0.55 + 0.3 * d2[inside])[:, None] * np.array(
                [0.6, 0.85, 0.6])
            boxes[b, k] = [cx - r, cy - r, cx + r, cy + r]
            masks[b, k] = (my - cy) ** 2 + (mx - cx) ** 2 < r * r
    bgr = np.clip(img, 0, 255)[..., ::-1]
    x = ((bgr - [103.53, 116.28, 123.675]) / [57.375, 57.12, 58.395])
    return (x.astype(np.float32), np.clip(boxes, 0, SIZE), masks,
            np.ones((n, crowns), bool))


@pytest.fixture(scope="module")
def models():
    jparams = jax_load(str(NPZ), depth=50)
    serving = MaskRCNN(MaskRCNNConfig(**KW))
    serving.load_state_dict(load_checkpoint(str(NPZ)), strict=True)
    return jparams, serving.to(torch.bfloat16).eval()


def _rel(got: torch.Tensor, ref) -> float:
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    return float(np.abs(got.float().numpy() - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def jax_levels(models):
    jparams, _ = models
    x = crown_scene(0)[0]
    levels = jax.jit(lambda p, im: JaxResNetFPN(depth=50, dtype=BF).apply(
        {"params": p}, im))(jparams["params"]["backbone"],
                            jnp.asarray(x).astype(BF))
    return x, levels


def test_backbone_levels_match_jax(models, jax_levels):
    _, port = models
    x, ref = jax_levels
    with torch.no_grad():
        got = port.backbone(torch.from_numpy(x).to(torch.bfloat16))
    assert len(got) == len(ref) == 5
    for lvl, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == r.shape
        assert _rel(g, r) <= TOL, (lvl + 2, _rel(g, r))


def test_rpn_outputs_match_jax(models, jax_levels):
    jparams, port = models
    levels = jax_levels[1]
    ref_lg, ref_dl = RPNHead(dtype=BF).apply(
        {"params": jparams["params"]["rpn_head"]}, levels)
    shared = [torch.from_numpy(np.asarray(f.astype(jnp.float32))).to(
        torch.bfloat16) for f in levels]
    with torch.no_grad():
        lg, dl = port.rpn_head(shared)
    for g, r in zip(lg + dl, list(ref_lg) + list(ref_dl)):
        assert _rel(g, r) <= TOL, _rel(g, r)


def test_heads_match_jax(models):
    jparams, port = models
    rng = np.random.default_rng(1)
    pooled = rng.standard_normal((64, 7, 7, 256)).astype(np.float32)
    mpooled = rng.standard_normal((16, 14, 14, 256)).astype(np.float32)
    ref_cls, ref_box = BoxHead(dtype=BF).apply(
        {"params": jparams["params"]["box_head"]},
        jnp.asarray(pooled).astype(BF))
    ref_mask = MaskHead(dtype=BF).apply(
        {"params": jparams["params"]["mask_head"]},
        jnp.asarray(mpooled).astype(BF))
    with torch.no_grad():
        cls, box = port.box_head(torch.from_numpy(pooled).to(torch.bfloat16))
        mask = port.mask_head(torch.from_numpy(mpooled).to(torch.bfloat16))
    for name, g, r in (("cls", cls, ref_cls), ("box", box, ref_box),
                       ("mask", mask, ref_mask)):
        assert _rel(g, r) <= TOL, (name, _rel(g, r))


def test_loss_terms_match_jax_in_bf16():
    """The trainer's bf16 (float32 parameters, bf16 convs and dense layers,
    batch of 2 with 12 crowns each) against JAX's ``bf16=True`` losses."""
    x, boxes, masks, valid = crown_scene(0)
    jparams = jax_load(str(NPZ), depth=50)
    jmodel = JaxMaskRCNN(JaxConfig(bf16=True, **KW))
    _, ref = jax.jit(lambda p: jl.mask_rcnn_losses(
        jmodel, p, *map(jnp.asarray, (x, boxes, masks, valid)),
        jax.random.PRNGKey(0)))(jparams)
    model = MaskRCNN(MaskRCNNConfig(bf16=True, **KW))
    model.load_state_dict(load_checkpoint(str(NPZ)), strict=True)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        _, got = tl.mask_rcnn_losses(model, *map(torch.from_numpy,
                                                 (x, boxes, masks, valid)))
    for k, v in ref.items():
        assert float(got[k]) == pytest.approx(float(v), rel=TOL), k


def _iou(a, b):
    lt = np.maximum(a[:2], b[:2])
    rb = np.minimum(a[2:], b[2:])
    inter = np.prod(np.clip(rb - lt, 0, None))
    union = np.prod(a[2:] - a[:2]) + np.prod(b[2:] - b[:2]) - inter
    return inter / union if union > 0 else 0.0


def _partnered(boxes, scores, valid, o_boxes, o_scores, o_valid, floor):
    """Each detection above ``floor`` has a partner among the others."""
    for i in np.flatnonzero(valid & (scores >= floor)):
        if not any(_iou(boxes[i], o_boxes[j]) >= 0.8
                   and abs(scores[i] - o_scores[j]) <= 0.05
                   for j in np.flatnonzero(o_valid)):
            return False
    return True


def test_detections_match_jax_up_to_near_ties(models, monkeypatch):
    import treedetection_tpu.models.mask_rcnn as jmr
    from treedetection_tpu.ops.roi_align import (
        multilevel_roi_align_batched as jax_pool)
    jparams, port = models
    monkeypatch.setattr(jmr, "multilevel_roi_align_batched", functools.partial(
        jax_pool, pallas=True, force_interpret=True))
    x = crown_scene(0)[0]
    cfg = JaxConfig(bf16=True, **KW)
    want = jax.jit(lambda p, im: JaxMaskRCNN(cfg).apply(p, im))(
        jparams, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    floor = cfg.score_threshold + 0.1
    ref = [np.asarray(a, np.float32) for a in (want.boxes, want.scores)] + [
        np.asarray(want.valid)]
    ours = [got.boxes.float().numpy(), got.scores.float().numpy(),
            got.valid.numpy()]
    assert (ref[2] & (ref[1] >= floor)).sum() > 0, "no confident detection"
    for b in range(x.shape[0]):
        r = [a[b] for a in ref]
        o = [a[b] for a in ours]
        assert _partnered(*r, *o, floor) and _partnered(*o, *r, floor), b
