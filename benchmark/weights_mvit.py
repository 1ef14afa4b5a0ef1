"""Seeded Mask R-CNN MViTv2 weights, drawn on the device, written as one
``.npz`` in the Flax checkpoint layout that both the port's loader and the
benchmark's reference (``reference/mvit.py``) read.

The layout: ``/``-joined keys under ``params/``, conv kernels HWIO (the
pooling convs (3, 3, 1, D): depthwise), dense kernels (in, out), layer
norms ``scale``/``bias``; the backbone's ``bottom_up/patch_embed/proj``,
its blocks ``bottom_up/blocks_{i}`` (``norm1``, ``attn/qkv``,
``attn/pool_{q,k,v}``, ``attn/norm_{q,k,v}``, ``attn/rel_pos_{h,w}`` at
the pretraining size's rows, ``attn/proj``, ``proj`` where the width
changes, ``norm2``, ``mlp/fc1``, ``mlp/fc2``), the stages' norms
``bottom_up/scale{k}_norm``, the FPN's ``fpn/lateral{l}`` and
``fpn/output{l}``; the heads are ``weights.py``'s R-FPN heads, leaf for
leaf.

The draw and the heads' calibration are ``weights.py``'s
(:func:`make_weights`, :func:`calibrate`: its ``make_weights`` over these
leaves, its ``calibrate`` with this reference in the R-FPN reference's
place), from the configuration's ``weights`` group.  Before the heads,
:func:`calibrate_attention` sets, block by block on the cell's own tiles
with the float32 reference, the scale of the q and k norms so that the
logits ``scale q.k`` have the standard deviation ``qk_logit_std``, and
each table so that its term ``q.R`` has ``rel_pos_term_std``, as
``weights_vitdet`` sets ViTDet's.
"""

from __future__ import annotations

import contextlib
import math
import sys
from typing import Dict, Iterator, List

import numpy as np
import torch

import weights as weights_mod
from weights import Leaf, _round
from weights_vitdet import _conv, _dense, _ln, _scaled, _std

BOTTOM_UP = "params/backbone/bottom_up"
FPN = "params/backbone/fpn"
HEADS = ("params/rpn_head/", "params/box_head/", "params/mask_head/")
# the R-FPN model's leaves, whose heads this model shares
RFPN_LEAVES = weights_mod.leaves


def leaves(model: Dict) -> List[Leaf]:
    """Every leaf of the checkpoint of ``model`` (the configuration's model
    group)."""
    from reference.mvit import PATCH_STRIDE, block_specs
    last = [int(i) for i in model["mvit_last_block_indexes"]]
    mlp = float(model["mvit_mlp_ratio"])
    out = _conv(f"{BOTTOM_UP}/patch_embed/proj", 7, 3,
                int(model["mvit_embed_dim"]), "lecun")
    side = int(model["mvit_pretrain_size"]) // PATCH_STRIDE
    widths = []
    for i, s in enumerate(block_specs(model)):
        blk = f"{BOTTOM_UP}/blocks_{i}"
        d = s.dim_out // s.heads
        rows = 2 * max(side // s.stride_q, side // s.stride_kv) - 1
        out += _ln(f"{blk}/norm1", s.dim)
        out += _dense(f"{blk}/attn/qkv", s.dim, 3 * s.dim_out, "lecun")
        for name in "qkv":
            out.append((f"{blk}/attn/pool_{name}/kernel", (3, 3, 1, d),
                        "lecun"))
            out += _ln(f"{blk}/attn/norm_{name}", d)
        out += [(f"{blk}/attn/rel_pos_h", (rows, d), "rel_pos"),
                (f"{blk}/attn/rel_pos_w", (rows, d), "rel_pos")]
        out += _dense(f"{blk}/attn/proj", s.dim_out, s.dim_out, "lecun")
        if s.dim != s.dim_out:
            out += _dense(f"{blk}/proj", s.dim, s.dim_out, "lecun")
        out += _ln(f"{blk}/norm2", s.dim_out)
        hidden = int(s.dim_out * mlp)
        out += _dense(f"{blk}/mlp/fc1", s.dim_out, hidden, "he")
        out += _dense(f"{blk}/mlp/fc2", hidden, s.dim_out, "lecun")
        if i in last:
            out += _ln(f"{BOTTOM_UP}/scale{len(widths) + 2}_norm", s.dim_out)
            widths.append(s.dim_out)
        if i - 1 in last:
            side //= 2
    f = int(model["fpn_channels"])
    for level, c in zip((2, 3, 4, 5), widths):
        out += _conv(f"{FPN}/lateral{level}", 1, c, f, "lecun")
        out += _conv(f"{FPN}/output{level}", 3, f, f, "lecun")
    out += [leaf for leaf in RFPN_LEAVES(dict(model, depth=50))
            if leaf[0].startswith(HEADS)]
    return out


@contextlib.contextmanager
def _in_place_of(module, name: str, value) -> Iterator[None]:
    """``module.name`` is ``value`` for the block's duration."""
    kept = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, kept)


def make_weights(model: Dict, init: Dict, seed: int,
                 device: torch.device) -> Dict[str, np.ndarray]:
    """-> the checkpoint's leaves as float16 numpy arrays: the draw of
    ``weights.make_weights`` (the same ``init`` groups) over
    :func:`leaves`."""
    with _in_place_of(weights_mod, "leaves", leaves):
        return weights_mod.make_weights(model, init, seed, device)


@torch.no_grad()
def calibrate_attention(weights: Dict[str, np.ndarray], model: Dict,
                        cal: Dict, x: torch.Tensor,
                        device: torch.device) -> List[tuple]:
    """Block by block on the reference's forward over the tiles ``x``:
    scale the q and k norms (scale and shift) so that the logits
    ``scale q.k`` of 2048 of the block's pooled queries against 2048 of its
    pooled keys have the standard deviation ``qk_logit_std``, then each
    relative-position table so that its term ``q.R[r]`` has
    ``rel_pos_term_std`` over those queries and every row the block reads;
    then run the block as rescaled.  -> per block the (logit, rel_h term,
    rel_w term) standard deviations before the rescale."""
    from reference.maskrcnn import tensors
    from reference.mvit import MViT, get_rel_pos
    ref = MViT(tensors(weights, device), model)
    h = ref.patch_embed(ref.preprocess(x))
    gen = torch.Generator(device="cpu").manual_seed(0)
    before = []

    def refresh(keys):
        for key in keys:
            ref.w[key] = torch.from_numpy(
                weights[key].astype(np.float32)).to(device)

    def sample(t: torch.Tensor) -> torch.Tensor:
        flat = t.reshape(-1, t.shape[-1])
        return flat[torch.randperm(flat.shape[0], generator=gen)[:2048]
                    .to(device)]

    for i, s in enumerate(ref.specs):
        key = f"{BOTTOM_UP}/blocks_{i}/attn"
        xn = ref.norm(h, f"{BOTTOM_UP}/blocks_{i}/norm1")
        q, k, _ = ref.pooled_qkv(xn, i)
        qs, ks = sample(q), sample(k)
        d = qs.shape[-1]
        std = _std((qs * d ** -0.5) @ ks.T)
        g = math.sqrt(_round(float(cal["qk_logit_std"]) / std))
        for name in "qk":
            for leaf in ("scale", "bias"):
                _scaled(weights, f"{key}/norm_{name}/{leaf}", g)
        qs = qs * g
        row = [std]
        q_side = (s.window // s.stride_q) if s.window else q.shape[1]
        k_side = (s.window // s.stride_kv) if s.window else k.shape[1]
        for axis in ("h", "w"):
            table = f"{key}/rel_pos_{axis}"
            used = get_rel_pos(q_side, k_side, ref.w[table]).reshape(-1, d)
            t_std = _std(qs @ used.T)
            row.append(t_std)
            _scaled(weights, table, _round(float(cal["rel_pos_term_std"])
                                           / t_std))
        refresh([f"{key}/norm_{n}/{leaf}" for n in "qk"
                 for leaf in ("scale", "bias")]
                + [f"{key}/rel_pos_h", f"{key}/rel_pos_w"])
        before.append(tuple(row))
        h = ref.block(h, i)
    return before


@torch.no_grad()
def calibrate(weights: Dict[str, np.ndarray], model: Dict, init: Dict,
              tiles: np.ndarray, device: torch.device) -> None:
    """Set the weights in place from their inputs on ``tiles`` (uint8 (n,
    P, P, 3) of the cell's own traffic), with the float32 reference: first
    the attention (:func:`calibrate_attention`), then what
    ``weights.calibrate`` sets for the R-FPN model (the FPN's levels, the
    RPN, the box head's deltas and class logits, the mask logits), with
    this reference in its place."""
    import reference.maskrcnn
    from reference.mvit import MViT
    x = torch.from_numpy(tiles).to(device)
    stds = calibrate_attention(weights, model, init["calibration"], x, device)
    print("benchmark: attention calibrated: logit, rel_h, rel_w std before "
          "(first and last block): " + ", ".join(
              f"{v:.3g}" for v in stds[0] + stds[-1]), file=sys.stderr,
          flush=True)
    with _in_place_of(reference.maskrcnn, "MaskRCNN", MViT):
        weights_mod.calibrate(weights, model, init, tiles, device)
