"""Seeded Mask R-CNN ViTDet weights, drawn on the device, written as one
``.npz`` in the Flax checkpoint layout that both the port's loader and the
benchmark's reference (``reference/vitdet.py``) read.

The layout: ``/``-joined keys under ``params/``, conv kernels HWIO, dense
kernels (in, out), transposed-conv kernels (kh, kw, in, out) spatially
flipped, layer norms ``scale``/``bias``, the ViT's blocks ``blocks_{i}``,
the pyramid's branches ``up2`` (``deconv1``, ``norm``, ``deconv2``) and
``up3`` (``deconv1``), its per-level ``lateral{l}`` and ``output{l}`` convs
with their ``norm``, the RPN head's convs ``conv/conv{i}``, the box head's
``conv{i}`` (with ``norm``) and ``fc1``.

The draw is ``weights.py``'s, from the configuration's ``weights`` group:
every kernel a normal of standard deviation ``sqrt(gain / fan_in)``
(``gains``), every norm scale its base times a uniform draw from
``scale_spread`` (``scales``), every shift, bias, position embedding and
relative-position table a normal of the standard deviation that ``biases``
names, the rest constants; one normal and one uniform vector drawn by a
generator seeded with ``--seed`` on the device.  :func:`calibrate` then
sets, on the cell's own tiles with the float32 reference, the attention's
scales (block by block: the q.k logits and the two relative-position
terms) and the heads' outputs, as ``weights.calibrate`` sets them for the
R-FPN model.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List

import numpy as np
import torch

from weights import Leaf, _count, _fan_in, _round

NET = "params/backbone/net"
PYRAMID = "params/backbone/pyramid"


def _ln(prefix: str, n: int) -> List[Leaf]:
    return [(f"{prefix}/scale", (n,), "norm_scale"),
            (f"{prefix}/bias", (n,), "shift")]


def _dense(prefix: str, cin: int, cout: int, gain: str) -> List[Leaf]:
    return [(f"{prefix}/kernel", (cin, cout), gain),
            (f"{prefix}/bias", (cout,), "bias")]


def _conv(prefix: str, k: int, cin: int, cout: int, gain: str,
          norm: bool = False) -> List[Leaf]:
    out = [(f"{prefix}/kernel", (k, k, cin, cout), gain)]
    return out + (_ln(f"{prefix}/norm", cout) if norm
                  else [(f"{prefix}/bias", (cout,), "bias")])


def leaves(model: Dict) -> List[Leaf]:
    """Every leaf of the checkpoint of ``model`` (the configuration's model
    group)."""
    p, d = int(model["vit_patch"]), int(model["vit_dim"])
    hd = d // int(model["vit_heads"])
    grid = int(model["input_size"]) // p
    pre = int(model["vit_pretrain_size"]) // p
    window = int(model["vit_window"])
    hidden = int(d * float(model["vit_mlp_ratio"]))
    out: List[Leaf] = _conv(f"{NET}/patch_embed/proj", p, 3, d, "lecun")
    out.append((f"{NET}/pos_embed", (1, pre * pre + 1, d), "pos"))
    glob = {int(i) for i in model["vit_global_blocks"]}
    for i in range(int(model["vit_depth"])):
        blk = f"{NET}/blocks_{i}"
        side = grid if i in glob else window
        out += _ln(f"{blk}/norm1", d)
        out += _dense(f"{blk}/attn/qkv", d, 3 * d, "lecun")
        out += _dense(f"{blk}/attn/proj", d, d, "lecun")
        out += [(f"{blk}/attn/rel_pos_h", (2 * side - 1, hd), "rel_pos"),
                (f"{blk}/attn/rel_pos_w", (2 * side - 1, hd), "rel_pos")]
        out += _ln(f"{blk}/norm2", d)
        out += _dense(f"{blk}/mlp/fc1", d, hidden, "he")
        out += _dense(f"{blk}/mlp/fc2", hidden, d, "lecun")
    f = int(model["fpn_channels"])
    out += _conv(f"{PYRAMID}/up2/deconv1", 2, d, d // 2, "lecun")
    out += _ln(f"{PYRAMID}/up2/norm", d // 2)
    out += _conv(f"{PYRAMID}/up2/deconv2", 2, d // 2, d // 4, "lecun")
    out += _conv(f"{PYRAMID}/up3/deconv1", 2, d, d // 2, "lecun")
    for level, cin in zip((2, 3, 4, 5), (d // 4, d // 2, d, d)):
        out += _conv(f"{PYRAMID}/lateral{level}", 1, cin, f, "lecun", True)
        out += _conv(f"{PYRAMID}/output{level}", 3, f, f, "lecun", True)
    a = len(model["anchor_ratios"])
    k = int(model["num_classes"])
    for i in range(int(model["rpn_convs"])):
        out += _conv(f"params/rpn_head/conv/conv{i}", 3, f, f, "he")
    out += _conv("params/rpn_head/objectness_logits", 1, f, a, "objectness")
    out += _conv("params/rpn_head/anchor_deltas", 1, f, 4 * a, "rpn_deltas")
    for i in range(int(model["box_head_convs"])):
        out += _conv(f"params/box_head/conv{i + 1}", 3, f, f, "he", True)
    fc = int(model["box_head_fc_dim"])
    out += _dense("params/box_head/fc1", f * int(model["box_pool"]) ** 2, fc,
                  "he")
    out += [("params/box_head/cls_score/kernel", (fc, k + 1), "cls"),
            ("params/box_head/cls_score/bias", (k + 1,), "cls_bias"),
            ("params/box_head/bbox_pred/kernel", (fc, 4 * k), "box_deltas"),
            ("params/box_head/bbox_pred/bias", (4 * k,), "bias")]
    for i in range(4):
        out += _conv(f"params/mask_head/mask_fcn{i + 1}", 3, f, f, "he",
                     True)
    out += _conv("params/mask_head/deconv", 2, f, f, "he")
    out += [("params/mask_head/predictor/kernel", (1, 1, f, k), "mask"),
            ("params/mask_head/predictor/bias", (k,), "mask_bias")]
    return out


def make_weights(model: Dict, init: Dict, seed: int,
                 device: torch.device) -> Dict[str, np.ndarray]:
    """-> the checkpoint's leaves as float16 numpy arrays, drawn as
    ``weights.make_weights`` draws them (the same ``init`` groups)."""
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
    host = torch.cat([t.reshape(-1) for t in out_dev.values()]).cpu().numpy()
    out: Dict[str, np.ndarray] = {}
    pos = 0
    for key, t in out_dev.items():
        n = t.numel()
        out[key] = host[pos:pos + n].reshape(tuple(t.shape))
        pos += n
    for key, shape, kind in spec:
        if key not in out:
            arr = np.empty(shape, dtype=np.float16)
            arr[...] = np.asarray(consts[kind], dtype=np.float16)
            out[key] = arr
    return out


def _scaled(weights: Dict[str, np.ndarray], key: str, gain,
            cols: slice = slice(None)) -> None:
    """``weights[key][..., cols] *= gain``, kept float16."""
    a = weights[key].astype(np.float32)
    a[..., cols] *= gain
    weights[key] = a.astype(np.float16)


def _std(t: torch.Tensor) -> float:
    return max(float(t.double().std()), 1e-12)


@torch.no_grad()
def calibrate_attention(weights: Dict[str, np.ndarray], model: Dict,
                        cal: Dict, x: torch.Tensor,
                        device: torch.device) -> List[tuple]:
    """Block by block on the reference's forward over the tiles ``x``:
    scale each block's q and k (kernel and bias columns of ``qkv``) so that
    the logits ``scale q.k`` of a sample of token pairs have the standard
    deviation ``qk_logit_std``, then each relative-position table so that
    its term ``q.R[r]`` has ``rel_pos_term_std`` (over every sampled query
    and table row); then run the block as rescaled.  -> per block the
    (logit, rel_h term, rel_w term) standard deviations before the
    rescale."""
    from reference.maskrcnn import tensors
    from reference.vitdet import ViTDet
    ref = ViTDet(tensors(weights, device), model)
    d = int(model["vit_dim"])
    heads = int(model["vit_heads"])
    hd = d // heads
    h = ref.patch_embed(ref.preprocess(x))
    h = h + ref.pos_embed(h.shape[1])
    gen = torch.Generator(device="cpu").manual_seed(0)
    tokens = h.shape[0] * h.shape[1] * h.shape[2]
    pick = torch.randperm(tokens, generator=gen)[:2048].to(device)
    before = []

    def refresh(keys):
        for key in keys:
            ref.w[key] = torch.from_numpy(
                weights[key].astype(np.float32)).to(device)

    for i in range(int(model["vit_depth"])):
        blk = f"{NET}/blocks_{i}"
        xn = ref.norm(h, f"{blk}/norm1").reshape(-1, d)[pick]
        qkv = ref.dense(xn, f"{blk}/attn/qkv").reshape(-1, 3, heads, hd)
        q, k = qkv[:, 0].transpose(0, 1), qkv[:, 1].transpose(0, 1)
        std = _std((q * hd ** -0.5) @ k.transpose(-1, -2))
        g = math.sqrt(_round(float(cal["qk_logit_std"]) / std))
        for leaf in ("kernel", "bias"):
            _scaled(weights, f"{blk}/attn/qkv/{leaf}", g, slice(0, 2 * d))
        q = q * g
        row = [std]
        for axis in ("h", "w"):
            key = f"{blk}/attn/rel_pos_{axis}"
            t_std = _std(q @ ref.w[key].T)
            row.append(t_std)
            _scaled(weights, key, _round(float(cal["rel_pos_term_std"])
                                         / t_std))
        refresh([f"{blk}/attn/qkv/kernel", f"{blk}/attn/qkv/bias",
                 f"{blk}/attn/rel_pos_h", f"{blk}/attn/rel_pos_w"])
        before.append(tuple(row))
        h = h + ref.block_attention(ref.norm(h, f"{blk}/norm1"), i)
        y = torch.nn.functional.gelu(ref.dense(ref.norm(h, f"{blk}/norm2"),
                                               f"{blk}/mlp/fc1"))
        h = h + ref.dense(y, f"{blk}/mlp/fc2")
    return before


@torch.no_grad()
def calibrate(weights: Dict[str, np.ndarray], model: Dict, init: Dict,
              tiles: np.ndarray, device: torch.device) -> None:
    """Set the weights in place from their inputs on ``tiles`` (uint8 (n,
    P, P, 3) of the cell's own traffic), with the float32 reference: first
    the attention (:func:`calibrate_attention`), then what
    ``weights.calibrate`` sets for the R-FPN model, with the same
    ``init["calibration"]`` keys: each pyramid level's standard deviation
    (its last channel norm's scale and shift scaled), the objectness signs,
    the RPN's and the box head's delta scales, the class logit's standard
    deviation and the offset that keeps ``detections_per_tile`` detections
    a tile, and the mask logit's spread and median."""
    from reference.maskrcnn import BOX_WEIGHTS, clip, decode, tensors
    from reference.vitdet import ViTDet
    cal = init["calibration"]
    x = torch.from_numpy(tiles).to(device)
    stds = calibrate_attention(weights, model, cal, x, device)
    print("benchmark: attention calibrated: logit, rel_h, rel_w std before "
          "(first and last block): " + ", ".join(
              f"{v:.3g}" for v in stds[0] + stds[-1]), file=sys.stderr,
          flush=True)

    def model_now():
        return ViTDet(tensors(weights, device), model)

    def rescale(layer: str, gain: float, leaves=("kernel", "bias")) -> None:
        for leaf in leaves:
            _scaled(weights, f"{layer}/{leaf}", gain)

    ref = model_now()
    feats = ref.backbone(ref.preprocess(x))
    for level, target in enumerate(cal["fpn_level_std"]):
        rescale(f"{PYRAMID}/output{level + 2}/norm", _round(
            float(target) / _std(feats[level])), ("scale", "bias"))
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
