"""Seeded Mask R-CNN R-FPN weights, drawn on the device, written as one
``.npz`` in the Flax checkpoint layout that both the port's loader and the
benchmark's reference read.

The layout is the one of a checkpoint saved by the training code: ``/``-joined
keys under ``params/``, conv kernels HWIO, dense kernels (in, out), the
transposed-conv kernel (kh, kw, in, out), frozen norms as ``scale``/``bias``,
and every block of a stage after the first stacked under
``res{s}_rest/block`` with a leading block axis.

How the values are drawn is the configuration's (its ``weights`` group):
every kernel is a normal of standard deviation ``sqrt(gain / fan_in)``
(``gains``), every norm scale its base times a uniform draw from
``scale_spread`` per channel (``scales``), every norm shift and bias a normal
of the standard deviation that ``biases`` names, and the rest a constant
(``constants``).  The draw is one normal vector of all kernels, shifts and
biases and one uniform vector of all norm scales, made by a generator seeded
with ``--seed`` on the device, then cut and scaled.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}

# (key, shape, kind): kind names the entry of the configuration's
# ``weights`` group that scales it ("he", "lecun", ...) or a constant
Leaf = Tuple[str, Tuple[int, ...], str]


def _conv_bn(prefix: str, kh: int, cin: int, cout: int, gain: str,
             scale: str, stack: int = 0) -> List[Leaf]:
    lead = (stack,) if stack else ()
    return [(f"{prefix}/conv/kernel", lead + (kh, kh, cin, cout), gain),
            (f"{prefix}/norm/scale", lead + (cout,), scale),
            (f"{prefix}/norm/bias", lead + (cout,), "shift")]


def _block(prefix: str, cin: int, width: int, cout: int, shortcut: bool,
           stack: int = 0) -> List[Leaf]:
    leaves = (_conv_bn(f"{prefix}/conv1", 1, cin, width, "he", "norm_scale",
                       stack)
              + _conv_bn(f"{prefix}/conv2", 3, width, width, "he",
                         "norm_scale", stack)
              + _conv_bn(f"{prefix}/conv3", 1, width, cout, "lecun",
                         "residual_scale", stack))
    if shortcut:
        leaves += _conv_bn(f"{prefix}/shortcut", 1, cin, cout, "lecun",
                           "norm_scale")
    return leaves


def leaves(model: Dict) -> List[Leaf]:
    """Every leaf of the checkpoint of ``model`` (the configuration's model
    group: ``depth``, ``num_classes``, ``anchor_ratios``, ``box_pool``)."""
    bu = "params/backbone/bottom_up"
    out = _conv_bn(f"{bu}/stem", 7, 3, 64, "he", "norm_scale")
    cin, width, cout = 64, 64, 256
    for s, n in enumerate(STAGE_BLOCKS[int(model["depth"])]):
        out += _block(f"{bu}/res{s + 2}_0", cin, width, cout, True)
        if n > 1:
            out += _block(f"{bu}/res{s + 2}_rest/block", cout, width, cout,
                          False, stack=n - 1)
        cin, width, cout = cout, width * 2, cout * 2
    fpn = "params/backbone/fpn"
    for i, c in enumerate((256, 512, 1024, 2048)):
        out += [(f"{fpn}/lateral{i + 2}/kernel", (1, 1, c, 256), "lecun"),
                (f"{fpn}/lateral{i + 2}/bias", (256,), "bias"),
                (f"{fpn}/output{i + 2}/kernel", (3, 3, 256, 256), "lecun"),
                (f"{fpn}/output{i + 2}/bias", (256,), "bias")]
    a = len(model["anchor_ratios"])
    k = int(model["num_classes"])
    out += [("params/rpn_head/conv/kernel", (3, 3, 256, 256), "he"),
            ("params/rpn_head/conv/bias", (256,), "bias"),
            ("params/rpn_head/objectness_logits/kernel", (1, 1, 256, a),
             "objectness"),
            ("params/rpn_head/objectness_logits/bias", (a,), "bias"),
            ("params/rpn_head/anchor_deltas/kernel", (1, 1, 256, 4 * a),
             "rpn_deltas"),
            ("params/rpn_head/anchor_deltas/bias", (4 * a,), "bias")]
    pooled = 256 * int(model["box_pool"]) ** 2
    out += [("params/box_head/fc1/kernel", (pooled, 1024), "he"),
            ("params/box_head/fc1/bias", (1024,), "bias"),
            ("params/box_head/fc2/kernel", (1024, 1024), "he"),
            ("params/box_head/fc2/bias", (1024,), "bias"),
            ("params/box_head/cls_score/kernel", (1024, k + 1), "cls"),
            ("params/box_head/cls_score/bias", (k + 1,), "cls_bias"),
            ("params/box_head/bbox_pred/kernel", (1024, 4 * k), "box_deltas"),
            ("params/box_head/bbox_pred/bias", (4 * k,), "bias")]
    for i in range(4):
        out += [(f"params/mask_head/mask_fcn{i + 1}/kernel", (3, 3, 256, 256),
                 "he"),
                (f"params/mask_head/mask_fcn{i + 1}/bias", (256,), "bias")]
    out += [("params/mask_head/deconv/kernel", (2, 2, 256, 256), "he"),
            ("params/mask_head/deconv/bias", (256,), "bias"),
            ("params/mask_head/predictor/kernel", (1, 1, 256, k), "mask"),
            ("params/mask_head/predictor/bias", (k,), "mask_bias")]
    return out


def _fan_in(key: str, shape: Tuple[int, ...]) -> int:
    core = shape[1:] if "_rest/" in key else shape
    if len(core) == 4:
        return core[0] * core[1] * core[2]
    return core[0]


def make_weights(model: Dict, init: Dict, seed: int,
                 device: torch.device) -> Dict[str, np.ndarray]:
    """-> the checkpoint's leaves as float16 numpy arrays.  ``init`` is the
    configuration's ``weights`` group: ``gains`` (kind -> gain of the
    kernels), ``biases`` (kind -> standard deviation of the shifts and
    biases), ``scales`` (kind -> base of the norm scales), ``scale_spread``
    (the uniform factor's low and high end), ``constants`` (kind -> value
    of the vectors)."""
    spec = leaves(model)
    gains, biases, scales = init["gains"], init["biases"], init["scales"]
    consts = init["constants"]
    normal = [(k, s, kind) for k, s, kind in spec
              if kind in gains or kind in biases]
    uniform = [(k, s, kind) for k, s, kind in spec if kind in scales]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(sum(math.prod(s) for _, s, _ in normal),
                       generator=gen, device=device, dtype=torch.float32)
    unit = torch.rand(sum(math.prod(s) for _, s, _ in uniform),
                      generator=gen, device=device, dtype=torch.float32)
    low, high = (float(v) for v in init["scale_spread"])
    out_dev: Dict[str, torch.Tensor] = {}
    pos = 0
    for key, shape, kind in normal:
        n = math.prod(shape)
        std = (math.sqrt(float(gains[kind]) / _fan_in(key, shape))
               if kind in gains else float(biases[kind]))
        out_dev[key] = (flat[pos:pos + n] * std).reshape(shape).to(
            torch.float16)
        pos += n
    pos = 0
    for key, shape, kind in uniform:
        n = math.prod(shape)
        factor = low + (high - low) * unit[pos:pos + n]
        out_dev[key] = (float(scales[kind]) * factor).reshape(shape).to(
            torch.float16)
        pos += n
    # one copy to the host for every drawn leaf
    host = torch.cat([t.reshape(-1) for t in out_dev.values()]).cpu().numpy()
    out: Dict[str, np.ndarray] = {}
    pos = 0
    for key, t in out_dev.items():
        n = t.numel()
        out[key] = host[pos:pos + n].reshape(tuple(t.shape))
        pos += n
    for key, shape, kind in spec:
        if key in out:
            continue
        value = consts[kind]
        arr = np.empty(shape, dtype=np.float16)
        arr[...] = np.asarray(value, dtype=np.float16)
        out[key] = arr
    return out


def write_weights(path: str, weights: Dict[str, np.ndarray]) -> None:
    """One uncompressed ``.npz`` (``/``-joined keys)."""
    np.savez(path, **weights)


def _round(x: float) -> float:
    """Four significant digits: the calibration's constants do not move
    with the last bits of the card's arithmetic."""
    return float(f"{x:.4g}")


def _count(logits: np.ndarray, boxes: torch.Tensor, shift: float,
           model: Dict) -> int:
    """Detections one tile keeps with ``shift`` on its class logits: above
    the score threshold, through NMS, at most the budget."""
    from reference.maskrcnn import nms
    probs = 1.0 / (1.0 + np.exp(-(logits + shift)))
    ok = probs > float(model["score_threshold"])
    if not ok.any():
        return 0
    keep = nms(boxes[torch.from_numpy(ok).to(boxes.device)],
               torch.from_numpy(probs[ok]).to(boxes.device),
               float(model["nms_threshold"]))
    return min(len(keep), int(model["max_detections"]))


@torch.no_grad()
def calibrate(weights: Dict[str, np.ndarray], model: Dict, init: Dict,
              tiles: np.ndarray, device: torch.device) -> None:
    """Set the FPN outputs, the RPN head's outputs and the box head's
    predictors in place from their inputs on ``tiles`` (uint8 (n, P, P, 3)
    of the cell's own traffic), with the float32 reference.  Random weights
    put one offset, drawn with the seed, on every box's class logit and
    every mask logit, so that without this a seed gives all boxes or none.
    ``init["calibration"]``: each FPN level P2-P5 gets the standard
    deviation ``fpn_level_std`` (its output conv and bias scaled; P6
    follows P5) and each anchor's objectness kernel and bias the sign with
    which it rises with that scale, so that the proposals take the anchor
    sizes of the level scaled most on every seed; the RPN's deltas get the
    root mean square ``rpn_delta_std`` and the box head's
    ``box_delta_std`` (kernel and bias scaled), so that decoding moves
    every box by a few pixels; the class logit over the post-NMS
    proposals gets the standard deviation ``class_logit_std``, and the
    offset with which the tiles keep ``detections_per_tile`` detections on
    average (bisection); the mask logit over the first ``max_detections``
    proposals gets ``mask_logit_std`` about ``mask_logit_median``.  The
    background logit is 0."""
    from reference.maskrcnn import BOX_WEIGHTS, MaskRCNN, clip, decode, tensors
    cal = init["calibration"]
    x = torch.from_numpy(tiles).to(device)

    def model_now():
        return MaskRCNN(tensors(weights, device), model)

    def rescale(layer: str, gain: float) -> None:
        for leaf in ("kernel", "bias"):
            key = f"{layer}/{leaf}"
            weights[key] = (weights[key].astype(np.float32) * gain).astype(
                np.float16)

    ref = model_now()
    feats = ref.backbone(ref.preprocess(x))
    for level, target in enumerate(cal["fpn_level_std"]):
        rescale(f"params/backbone/fpn/output{level + 2}", _round(
            float(target) / max(float(feats[level].std()), 1e-12)))
    # each anchor's objectness rises with its level's scale only where it
    # is positive on average: flip the anchors whose mean is negative, so
    # that the proposals come from the level scaled most
    ref = model_now()
    feats, rpn = ref.features(x)
    means = sum(lg.mean(dim=0).double().cpu().numpy().reshape(
        -1, len(model["anchor_ratios"])).mean(axis=0) for lg, _ in rpn)
    sign = np.where(means < 0, -1, 1).astype(np.float16)
    for leaf in ("kernel", "bias"):
        key = f"params/rpn_head/objectness_logits/{leaf}"
        weights[key] = weights[key] * sign
    rms = math.sqrt(sum(float((dl.double() ** 2).sum()) for _, dl in rpn)
                    / sum(dl.numel() for _, dl in rpn))
    rescale("params/rpn_head/anchor_deltas",
            _round(float(cal["rpn_delta_std"]) / max(rms, 1e-12)))
    ref = model_now()
    feats, rpn = ref.features(x)
    hs, props_all = [], []
    for i in range(tiles.shape[0]):
        _, (props, _) = ref.proposals(rpn, i)
        hs.append(ref.box_features(feats, i, props))
        props_all.append(props)
    raw = torch.cat([ref.dense(h, "params/box_head/bbox_pred")[:, :4]
                     for h in hs]).double()
    gain = _round(float(cal["box_delta_std"])
                  / max(float(raw.pow(2).mean().sqrt()), 1e-12))
    rescale("params/box_head/bbox_pred", gain)
    cls_in, mask_in, boxes = [], [], []
    d = int(model["max_detections"])
    k = weights["params/box_head/cls_score/kernel"].astype(np.float64)
    w = k[:, 0] - k[:, 1]
    for i, (h, props) in enumerate(zip(hs, props_all)):
        cls_in.append(h.double().cpu().numpy())
        deltas = ref.dense(h, "params/box_head/bbox_pred")[:, :4] * gain
        boxes.append(clip(decode(deltas, props, BOX_WEIGHTS), ref.size))
        mask_in.append(ref.mask_features(feats[:4], i, props[:d]))
    logits = [h @ w for h in cls_in]
    scale = _round(float(cal["class_logit_std"])
                   / max(np.concatenate(logits).std(), 1e-12))
    logits = [lg * scale for lg in logits]
    target = float(cal["detections_per_tile"])
    lo, hi = -1e3, 1e3
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        n = np.mean([_count(lg, bx, mid, model)
                     for lg, bx in zip(logits, boxes)])
        lo, hi = (mid, hi) if n < target else (lo, mid)
    shift = _round(0.5 * (lo + hi))
    new_k = np.zeros_like(k)
    new_k[:, 0] = w * scale
    weights["params/box_head/cls_score/kernel"] = new_k.astype(np.float16)
    weights["params/box_head/cls_score/bias"] = np.array(
        [shift] + [0.0] * (k.shape[1] - 1), np.float16)

    f = torch.cat(mask_in).permute(0, 2, 3, 1).reshape(
        -1, mask_in[0].shape[1]).double().cpu().numpy()
    mk = weights["params/mask_head/predictor/kernel"].astype(np.float64)
    mb = weights["params/mask_head/predictor/bias"].astype(np.float64)
    ml = f @ mk[0, 0, :, 0] + mb[0]
    mscale = _round(float(cal["mask_logit_std"]) / max(ml.std(), 1e-12))
    mshift = _round(float(cal["mask_logit_median"])
                    - np.median(ml) * mscale + mb[0] * mscale)
    weights["params/mask_head/predictor/kernel"] = (mk * mscale).astype(
        np.float16)
    weights["params/mask_head/predictor/bias"] = np.array(
        [mshift] + [0.0] * (mb.shape[0] - 1), np.float16)
