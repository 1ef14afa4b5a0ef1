"""The work of Mask R-CNN ViTDet and of its attention kernel, counted from
the configuration's shapes (2 operations per multiply-add), as the kept
outputs need it, whatever implements it.

``forward_flops`` counts the matrix work of one tile's forward at the
model's input size: the patch embedding; per block the qkv, output, and
MLP projections of the map's tokens (a window's pad tokens need none: their
q, k and v are the qkv bias) and the attention (:func:`attention_macs`);
the simple feature pyramid; the RPN head's convs on P2-P6; the box head's
convs and FC on every post-NMS proposal; the mask head on every detection
slot (``flops.mask_head_macs``).  Norms, activations, resize, NMS and
pooling are left out, as ``flops.forward_flops`` leaves them out.

``attention_work`` counts one launch of the attention kernel, which serves
one block over a batch: the map's real queries, each against its window's
keys (pad keys included: they enter the softmax) for q.k and p.v, the two
bias products q.Rh and q.Rw against the key rows and columns of its window,
and the bytes of q, k and v of the map, the bias, the output and both
tables, each read or written once.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import flops
from flops import _conv

FPN_STRIDES = (4, 8, 16, 32, 64)


def _grid(model: Dict) -> int:
    return int(model["input_size"]) // int(model["vit_patch"])


def _window(model: Dict, block: int) -> Tuple[int, int]:
    """(Sh, Sw) of a block's attention: the window, or the whole map."""
    glob = {int(i) for i in model["vit_global_blocks"]}
    w = int(model["vit_window"])
    return (_grid(model),) * 2 if block in glob else (w, w)


def attention_macs(model: Dict, sh: int, sw: int) -> int:
    """Multiply-adds of one image's attention in a block of (Sh, Sw)
    windows: every real query against its window's Sh * Sw keys (q.k and
    p.v) and against the Sh + Sw rows of the two tables."""
    n = _grid(model) ** 2
    d = int(model["vit_dim"])           # heads x head size
    return n * d * (2 * sh * sw + sh + sw)


def vit_macs(model: Dict) -> int:
    p, d = int(model["vit_patch"]), int(model["vit_dim"])
    n = _grid(model) ** 2
    hidden = int(d * float(model["vit_mlp_ratio"]))
    macs = n * p * p * 3 * d                             # patch embedding
    for i in range(int(model["vit_depth"])):
        macs += n * d * (3 * d + d + 2 * hidden)         # qkv, proj, MLP
        macs += attention_macs(model, *_window(model, i))
    return macs


def pyramid_macs(model: Dict) -> int:
    g, d = _grid(model), int(model["vit_dim"])
    f = int(model["fpn_channels"])
    # the deconvs: each output pixel takes one input pixel's channels
    macs = (2 * g) ** 2 * d * (d // 2) + (4 * g) ** 2 * (d // 2) * (d // 4)
    macs += (2 * g) ** 2 * d * (d // 2)
    for hw, cin in ((4 * g, d // 4), (2 * g, d // 2), (g, d), (g // 2, d)):
        macs += _conv(hw, 1, cin, f) + _conv(hw, 3, f, f)
    return macs


def rpn_macs(model: Dict) -> int:
    s, f = int(model["input_size"]), int(model["fpn_channels"])
    a = len(model["anchor_ratios"])
    macs = 0
    for stride in FPN_STRIDES:
        hw = math.ceil(s / stride)
        macs += (int(model["rpn_convs"]) * _conv(hw, 3, f, f)
                 + _conv(hw, 1, f, a) + _conv(hw, 1, f, 4 * a))
    return macs


def box_head_macs(model: Dict) -> int:
    f, r = int(model["fpn_channels"]), int(model["box_pool"])
    fc, k = int(model["box_head_fc_dim"]), int(model["num_classes"])
    per_box = (int(model["box_head_convs"]) * _conv(r, 3, f, f)
               + f * r * r * fc + fc * (k + 1) + fc * 4 * k)
    return int(model["rpn_post_nms_topk"]) * per_box


def forward_flops(model: Dict) -> int:
    """Operations of one tile's forward."""
    return 2 * (vit_macs(model) + pyramid_macs(model) + rpn_macs(model)
                + box_head_macs(model) + flops.mask_head_macs(model))


def attention_work(model: Dict, tiles: int) -> Dict[str, Tuple[int, int]]:
    """-> {"window": (operations, bytes), "global": (...)} of one launch of
    the attention kernel over ``tiles`` images, bfloat16 throughout."""
    g, d = _grid(model), int(model["vit_dim"])
    hd = d // int(model["vit_heads"])
    out = {}
    for kind, (sh, sw) in (("window", (int(model["vit_window"]),) * 2),
                           ("global", (g, g))):
        ops = 2 * tiles * attention_macs(model, sh, sw)
        # q, k, v and the output of the map; the bias; both tables (shared
        # by the heads)
        nbytes = 2 * (tiles * g * g * 4 * d + 3 * d
                      + (2 * sh - 1 + 2 * sw - 1) * hd)
        out[kind] = (ops, nbytes)
    return out


def attention_launches(model: Dict) -> Dict[str, int]:
    """Launches of the attention kernel in one forward, by kind."""
    glob = {int(i) for i in model["vit_global_blocks"]}
    n = int(model["vit_depth"])
    return {"window": n - len(glob & set(range(n))),
            "global": len(glob & set(range(n)))}
