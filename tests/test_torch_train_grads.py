"""The gradients of the port's training losses against the JAX package's
(``treedetection_tpu/train/losses.py``) on the CPU, at
``tests/test_train.py``'s TINY size with JAX's parameters and batch
(``test_torch_train_losses.jax_runs``).

Tolerances:
- stage by stage on shared inputs in float64 (where rounding cannot flip a
  ReLU decision), within 1e-3 of each tensor's max-abs: the stem conv, a
  res5 bottleneck's convs, the FPN convs, the RPN head under the RPN loss,
  the box head under the box losses, the mask head under the mask loss;
- the whole call's gradients in float32 within 1e-2 of each tensor's L2
  norm: at random init a pre-activation that rounds to the other side of 0
  in one package moves that position's whole contribution (a 2e-5 relative
  change of the input moves the port's own gradients by 1-9% of max-abs),
  so a max-abs bound would read rounding, not the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_train_losses import (  # noqa: F401 (fixtures)
    KEYS, jax_runs, port_model, torch_batch, torch_threads)
from treedetection_tpu.models import resnet as jax_resnet
from treedetection_tpu.models.anchors import pyramid_anchors as jax_anchors
from treedetection_tpu.models.roi_heads import BoxHead, MaskHead
from treedetection_tpu.models.rpn import RPNHead
from treedetection_tpu.train import losses as jl

from treedetection_tpu_torch.models.convert import from_flax_params
from treedetection_tpu_torch.train import losses as tl


def _close(got: torch.Tensor, ref, what: str, rtol: float = 1e-3) -> None:
    ref = torch.as_tensor(np.ascontiguousarray(ref), dtype=torch.float64)
    err = float((got.double() - ref).abs().max())
    assert err <= rtol * float(ref.abs().max()), (what, err,
                                                   float(ref.abs().max()))


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


@pytest.mark.parametrize("norm", ["frozen", "batch"])
def test_stage_gradients_match_jax(jax_runs, norm):
    """Each stage on the same float64 inputs and cotangents in both
    packages (Flax modules built with ``dtype=float64``; Flax's batch norm
    still returns float32): stem, a res5 bottleneck, FPN, then the RPN,
    box and mask heads under their own losses."""
    import flax.linen as fnn
    rng = np.random.default_rng(9)
    _, params, batch, _, _, stats, props, pscores = jax_runs[norm]
    p = _f64(jax.device_get(params)["params"])
    s = _f64(stats) if stats else {}
    model = port_model(params, norm=norm).double()
    bu = model.backbone.bottom_up
    f64 = jnp.float64

    def variables(path):
        out = {"params": p}
        if s:
            out["batch_stats"] = s
        for k in path:
            out = {kk: v[k] for kk, v in out.items() if k in v}
        return out

    def jgrad(module, path, x, cot):
        def f(var_params):
            v = {**variables(path), "params": var_params}
            y = module.apply(v, x, mutable=["batch_stats"] if s else False)
            y = y[0] if s else y
            return sum((jnp.asarray(a, f64) * c).sum()
                       for a, c in zip(jax.tree.leaves(y), cot))
        return jax.jit(jax.grad(f))(variables(path)["params"])

    with jax.enable_x64(True):
        # stem (ConvBN + max-pool) on the batch's images
        x = batch["image"].astype(np.float64)

        class Stem(fnn.Module):
            @fnn.compact
            def __call__(self, x):
                y = jax_resnet.ConvBN(64, kernel=7, stride=2, dtype=f64,
                                      norm=norm, name="stem")(x)
                return fnn.max_pool(y, (3, 3), strides=(2, 2),
                                    padding=((1, 1), (1, 1)))

        cot = [rng.standard_normal((2, 32, 32, 64))]
        g = jgrad(Stem(), ["backbone", "bottom_up"], jnp.asarray(x), cot)
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        y = F.max_pool2d(bu.stem(xt), 3, 2, 1).permute(0, 2, 3, 1)
        (y * torch.from_numpy(cot[0])).sum().backward()
        _close(bu.stem.conv.weight.grad, np.transpose(
            g["stem"]["conv"]["kernel"], (3, 2, 0, 1)), "stem conv")

        # res5's first (strided, projecting) bottleneck
        x = np.maximum(rng.standard_normal((2, 8, 8, 1024)), 0)
        block = jax_resnet.Bottleneck(512, 2048, stride=2, dtype=f64,
                                      norm=norm)
        cot = [rng.standard_normal((2, 4, 4, 2048))]
        g = jgrad(block, ["backbone", "bottom_up", "res5_0"], jnp.asarray(x),
                  cot)
        y = bu.res5[0](torch.from_numpy(x).permute(0, 3, 1, 2))
        (y.permute(0, 2, 3, 1) * torch.from_numpy(cot[0])).sum().backward()
        for name in ("conv1", "conv2", "conv3", "shortcut"):
            _close(getattr(bu.res5[0], name).conv.weight.grad, np.transpose(
                g[name]["conv"]["kernel"], (3, 2, 0, 1)), f"res5 {name}")

        # FPN on C2..C5
        cs = [rng.standard_normal((2, 128 // st, 128 // st, c))
              for st, c in ((4, 256), (8, 512), (16, 1024), (32, 2048))]
        cot = [rng.standard_normal((2, 128 // st, 128 // st, 256))
               for st in (4, 8, 16, 32, 64)]
        g = jgrad(jax_resnet.FPN(256, dtype=f64), ["backbone", "fpn"],
                  [jnp.asarray(c) for c in cs], cot)
        ys = model.backbone.fpn([torch.from_numpy(c).permute(0, 3, 1, 2)
                                 for c in cs])
        sum((y.permute(0, 2, 3, 1) * torch.from_numpy(c)).sum()
            for y, c in zip(ys, cot)).backward()
        for name in ("output2", "lateral5", "output5"):
            _close(getattr(model.backbone.fpn, name).weight.grad,
                   np.transpose(g[name]["kernel"], (3, 2, 0, 1)),
                   f"fpn {name}")

        # the RPN head under the RPN loss, on shared P2..P6
        feats = [rng.standard_normal((2, -(-128 // st), -(-128 // st), 256))
                 for st in (4, 8, 16, 32, 64)]
        anchors = [np.asarray(a) for a in jax_anchors(128)]
        gt = [batch["boxes"], batch["masks"], batch["valid"]]

        def rpn_total(rp):
            lg, dl = RPNHead(dtype=f64).apply({"params": rp},
                                              [jnp.asarray(f) for f in feats])
            per = jax.vmap(lambda l, d, b, m, v: jl.rpn_loss(
                l, d, [jnp.asarray(a) for a in anchors],
                jl.GroundTruth(b, m, v)))(lg, dl, *map(jnp.asarray, gt))
            return sum(v.mean() for v in per.values())

        g = jax.jit(jax.grad(rpn_total))(p["rpn_head"])
        lg, dl = model.rpn_head([torch.from_numpy(f) for f in feats])
        per = tl.rpn_loss(lg, dl, [torch.from_numpy(a) for a in anchors],
                          tl.GroundTruth(*map(torch.from_numpy, gt)))
        sum(v.mean() for v in per.values()).backward()
        for name in ("conv", "objectness_logits", "anchor_deltas"):
            _close(getattr(model.rpn_head, name).weight.grad, np.transpose(
                g[name]["kernel"], (3, 2, 0, 1)), f"rpn {name}")

        # the box head under the box losses, on JAX's proposals + the GT
        prop = np.concatenate([props, batch["boxes"]], axis=1)
        pvalid = np.concatenate([pscores > -np.inf, batch["valid"]], axis=1)
        fg, bg, best_gt, best_iou = (np.asarray(a) for a in jax.vmap(
            lambda pr, pv, b, m, v: jl.assign_proposals(
                pr, pv, jl.GroundTruth(b, m, v)))(
                    *map(jnp.asarray, [prop, pvalid] + gt)))
        n = prop.shape[1]
        pooled = rng.standard_normal((2, n, 7, 7, 256))

        def box_total(bp):
            cl, bd = BoxHead(dtype=f64).apply(
                {"params": bp}, jnp.asarray(pooled.reshape(2 * n, 7, 7, 256)))
            cl, bd = cl.reshape(2, n, -1), bd.reshape(2, n, -1)
            per = jax.vmap(lambda c, d, pr, f_, b_, bg_, bb, m, v:
                           jl.roi_box_losses(c, d[:, :4], pr, f_, b_, bg_,
                                             jl.GroundTruth(bb, m, v)))(
                cl, bd, *map(jnp.asarray, [prop, fg, bg, best_gt] + gt))
            return sum(v.mean() for v in per.values())

        g = jax.jit(jax.grad(box_total))(p["box_head"])
        cl, bd = model.box_head(torch.from_numpy(pooled.reshape(
            2 * n, 7, 7, 256)))
        per = tl.roi_box_losses(
            cl.reshape(2, n, -1), bd.reshape(2, n, -1)[..., :4],
            *map(torch.from_numpy, [prop, fg, bg, best_gt]),
            tl.GroundTruth(*map(torch.from_numpy, gt)))
        sum(v.mean() for v in per.values()).backward()
        for name in ("fc1", "fc2", "cls_score", "bbox_pred"):
            _close(getattr(model.box_head, name).weight.grad,
                   np.asarray(g[name]["kernel"]).T, f"box {name}")

        # the mask head under the mask loss, on the first of the fg
        # budget's boxes (float64 convolutions on the CPU are slow)
        m = 4
        sel = np.argsort(-np.where(fg, best_iou, -1.0), axis=1,
                         kind="stable")[:, :m]
        take = [np.take_along_axis(a, sel if a.ndim == 2 else sel[..., None],
                                   axis=1) for a in (prop, fg, best_gt)]
        mpooled = rng.standard_normal((2, m, 14, 14, 256))

        def mask_total(mp):
            lg = MaskHead(dtype=f64).apply(
                {"params": mp}, jnp.asarray(mpooled.reshape(2 * m, 14, 14,
                                                            256)))
            lg = lg[..., 0].reshape(2, m, 28, 28)
            return jax.vmap(lambda l, pr, f_, bg_, bb, mm, v:
                            jl.roi_mask_loss(l, pr, f_, bg_,
                                             jl.GroundTruth(bb, mm, v)))(
                lg, *map(jnp.asarray, take + gt)).mean()

        g = jax.jit(jax.grad(mask_total))(p["mask_head"])
        lg = model.mask_head(torch.from_numpy(mpooled.reshape(2 * m, 14, 14,
                                                              256)))
        tl.roi_mask_loss(lg[..., 0].reshape(2, m, 28, 28),
                         *map(torch.from_numpy, take),
                         tl.GroundTruth(*map(torch.from_numpy, gt))
                         ).mean().backward()
        for name in ("mask_fcn1", "mask_fcn4", "predictor"):
            _close(getattr(model.mask_head, name).weight.grad, np.transpose(
                g[name]["kernel"], (3, 2, 0, 1)), f"mask {name}")
        _close(model.mask_head.deconv.weight.grad, np.transpose(
            np.asarray(g["deconv"]["kernel"])[::-1, ::-1], (2, 3, 0, 1)),
            "mask deconv")


@pytest.mark.parametrize("norm", ["frozen", "batch"])
def test_whole_call_gradients_match_jax(jax_runs, norm):
    """The gradients of the whole loss in float32 for the named tensors,
    within 1e-2 of each tensor's L2 norm (see the module docstring)."""
    jmodel, params, batch, _, _, _, _, _ = jax_runs[norm]
    args = [jnp.asarray(batch[k]) for k in KEYS]
    g = jax.jit(jax.grad(lambda prm: jl.mask_rcnn_losses(
        jmodel, prm, *args, jax.random.PRNGKey(0))[0]))(params)
    ref = from_flax_params({"params": jax.device_get(g)["params"]})
    model = port_model(params, norm=norm)
    t, _ = tl.mask_rcnn_losses(model, *torch_batch(batch))
    t.backward()
    grads = {n: q.grad for n, q in model.named_parameters()}
    for name in ("backbone.bottom_up.stem.conv.weight",
                 "backbone.bottom_up.res5.0.shortcut.conv.weight",
                 "backbone.fpn.output2.weight", "rpn_head.conv.weight",
                 "box_head.fc1.weight", "mask_head.mask_fcn1.weight"):
        err = float((grads[name] - ref[name]).norm())
        assert err <= 1e-2 * float(ref[name].norm()), (name, err)
