"""The work of Mask R-CNN MViTv2 and of its pooling attention kernel,
counted from the configuration's shapes (2 operations per multiply-add),
as the kept outputs need it, whatever implements it.

``forward_flops`` counts the matrix work of one tile's forward at the
model's input size: the patch embedding; per block the qkv projection of
its input map, the three depthwise pooling convs (9 multiply-adds an
output), the attention (:func:`attention_macs`), the output projection and
the MLP on the pooled map, and the skip's projection of the input map
where the width changes; the FPN's lateral and output convs; the RPN head,
the box head and the mask head as ``flops.py`` counts the R-FPN heads.
Norms, activations, max-pools, resize, NMS and pooling are left out, as
``flops.forward_flops`` leaves them out.

``attention_work`` counts one launch of the kernel, which serves one block
over a batch: the map's real queries, each against its window's keys (pad
keys included: they enter the softmax) for q.k and p.v, and against the
key rows and columns of its window for the two bias products q.Rh and
q.Rw; and the bytes of q (whose values the residual adds too), k, v, the
output and both tables at the rows read, each read or written once.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import flops
from flops import _conv
from reference.mvit import PATCH_STRIDE, block_specs


class Shape(NamedTuple):
    side: int          # the block's input map side
    q: Tuple[int, int]     # query map, query window (the map if global)
    kv: Tuple[int, int]    # key map, key window


def _pooled(side: int, stride: int) -> int:
    return -(-side // stride)


def shapes(model: Dict) -> List[Shape]:
    """Each block's map sides and window sides at the model's input."""
    side = _pooled(int(model["input_size"]), PATCH_STRIDE)
    out = []
    for s in block_specs(model):
        hq, hk = _pooled(side, s.stride_q), _pooled(side, s.stride_kv)
        out.append(Shape(side, (hq, s.window // s.stride_q if s.window
                                else hq),
                         (hk, s.window // s.stride_kv if s.window else hk)))
        side = hq
    return out


def attention_macs(model: Dict, block: int) -> int:
    """Multiply-adds of one image's attention in ``block``: every real
    query against its window's keys (q.k and p.v) and against its key
    window's rows and columns (the two bias products)."""
    s, sh = block_specs(model)[block], shapes(model)[block]
    kv_win = sh.kv[1]
    return sh.q[0] ** 2 * s.dim_out * (2 * kv_win ** 2 + 2 * kv_win)


def mvit_macs(model: Dict) -> int:
    e = int(model["mvit_embed_dim"])
    mlp = float(model["mvit_mlp_ratio"])
    first = shapes(model)[0].side
    macs = _conv(first, 7, 3, e)                          # patch embedding
    for i, (s, sh) in enumerate(zip(block_specs(model), shapes(model))):
        n_in, n_q, n_k = sh.side ** 2, sh.q[0] ** 2, sh.kv[0] ** 2
        macs += n_in * s.dim * 3 * s.dim_out               # qkv
        macs += 9 * s.dim_out * (n_q + 2 * n_k)             # pooling convs
        macs += attention_macs(model, i)
        macs += n_q * s.dim_out * s.dim_out                 # proj
        if s.dim != s.dim_out:
            macs += n_in * s.dim * s.dim_out                # the skip's
        macs += 2 * n_q * s.dim_out * int(s.dim_out * mlp)  # MLP
    return macs


def fpn_macs(model: Dict) -> int:
    f = int(model["fpn_channels"])
    last = [int(i) for i in model["mvit_last_block_indexes"]]
    specs, shp = block_specs(model), shapes(model)
    macs = 0
    for i in last:
        hw, c = shp[i].q[0], specs[i].dim_out
        macs += _conv(hw, 1, c, f) + _conv(hw, 3, f, f)
    return macs


def forward_flops(model: Dict) -> int:
    """Operations of one tile's forward."""
    return 2 * (mvit_macs(model) + fpn_macs(model) + flops.rpn_macs(model)
                + flops.box_head_macs(model) + flops.mask_head_macs(model))


def attention_work(model: Dict, tiles: int) -> List[Tuple[int, int]]:
    """-> per block, (operations, bytes) of its one launch of the kernel
    over ``tiles`` images, bfloat16 throughout."""
    out = []
    for i, (s, sh) in enumerate(zip(block_specs(model), shapes(model))):
        ops = 2 * tiles * attention_macs(model, i)
        rows = sum(2 * max(sh.q[1], sh.kv[1]) - 1 for _ in range(2))
        d = s.dim_out // s.heads
        # q, k, v and the output of the batch's maps; both tables
        nbytes = 2 * (tiles * s.dim_out * (2 * sh.q[0] ** 2
                                           + 2 * sh.kv[0] ** 2) + rows * d)
        out.append((ops, nbytes))
    return out


def attention_launches(model: Dict) -> Dict[str, int]:
    """Launches of the kernel in one forward, by kind."""
    glob = sum(1 for s in block_specs(model) if not s.window)
    return {"window": len(block_specs(model)) - glob, "global": glob}


def least_seconds(model: Dict, tiles: int) -> float:
    """The least time the card could take for one forward's launches."""
    return sum(flops.roofline_seconds(ops, nbytes, "bfloat16")
               for ops, nbytes in attention_work(model, tiles))

