"""Plain Mask R-CNN MViTv2 inference in float32, the benchmark's reference
for the MViTv2-T configuration.

detectron2's ``projects/MViTv2/configs/mask_rcnn_mvitv2_t_3x.py`` at
inference (the backbone of ``modeling/backbone/mvit.py``: ``MViT``,
``MultiScaleBlock``, ``MultiScaleAttention``; the heads of
``configs/common/models/mask_rcnn_fpn.py``), written out in plain PyTorch
operations over a checkpoint in the Flax ``.npz`` layout
(``weights_mvit.py``).  It is ``maskrcnn.MaskRCNN`` (the R-FPN heads,
anchors, proposals, ROIAlign, box decoding, NMS, the detections'
selection) with two parts replaced:

* input: ``vitdet.ViTDet``'s (RGB, ImageNet mean and std, bilinear resize
  to the model's square input);
* the backbone: a 7 x 7 / 4 patch conv with bias (padding 3); blocks as
  ``MultiScaleBlock`` computes them: LayerNorm (eps 1e-6); the qkv
  projection split in the (3, heads, D) channel order; q, k and v each
  pooled by ``attention_pool`` (its depthwise 3 x 3 conv without bias,
  padding 1, q at its stride and k, v at theirs) and normed; in a windowed
  block each map zero-padded and partitioned by ``window_partition`` into
  windows of its own side (window / stride), the pads taking part in the
  softmax unmasked; the logits ``scale q.k`` with
  ``add_decomposed_rel_pos``'s two terms (q unscaled), their rows from
  ``get_rel_pos``: the table resized linearly where its length differs
  from 2 max(q, k) - 1, the index scaled where the sides differ; softmax
  over every key, ``window_unpartition``, the pooled q added (residual
  pooling), the output projection; the skip (the input, or its projection
  of the normed input where the width changes, max-pooled 3 x 3 / 2 where
  q is pooled) plus the attention, then LayerNorm, the MLP (exact GELU)
  and its residual; each stage's output through its ``scale{k}_norm``;
  the FPN of ``maskrcnn.MaskRCNN`` on those four maps (lateral 1 x 1 and
  output 3 x 3 convs with bias, nearest top-down, P6 = P5 subsampled).

The blocks' strides, windows and tables follow ``MViT.__init__`` from the
configuration's ``mvit_*`` widths.  The attention logits are materialised
in float32, one (image, head) at a time in the global blocks, so that
they fit.  Departures from detectron2, each the deployment's, as in
``maskrcnn.py``: no minimum box size in the RPN, the input resized on the
device without aspect handling (tiles are square), one class, 512 post-NMS
proposals and a score threshold of 0.3.  It imports no code of the
program under test.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from .maskrcnn import MaskRCNN, Quant, pyramid_anchors
from .vitdet import ViTDet, layer_norm

BOTTOM_UP = "params/backbone/bottom_up"
FPN = "params/backbone/fpn"
PATCH_STRIDE = 4


class BlockSpec(NamedTuple):
    dim: int
    dim_out: int
    heads: int
    stride_q: int
    stride_kv: int
    window: int            # 0: global


def block_specs(model: Dict) -> List[BlockSpec]:
    """Each block's widths, strides and window, as ``MViT.__init__`` sets
    them from ``model``'s ``mvit_*`` keys."""
    last = [int(i) for i in model["mvit_last_block_indexes"]]
    dim = dim_out = int(model["mvit_embed_dim"])
    heads = int(model["mvit_num_heads"])
    kv = int(model["mvit_adaptive_kv_stride"])
    window = int(model["mvit_adaptive_window_size"])
    out = []
    for i in range(int(model["mvit_depth"])):
        out.append(BlockSpec(dim, dim_out, heads, 2 if i - 1 in last else 1,
                             kv * 2 if i in last[1:3] else kv,
                             0 if i in last[1:] else window))
        dim = dim_out
        if i in last:
            dim_out, heads = dim_out * 2, heads * 2
            kv = max(kv // 2, 1)
        if i - 1 in last:
            window //= 2
    return out


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor
                ) -> torch.Tensor:
    """detectron2's ``get_rel_pos``: (q_size, k_size, D) rows of the table,
    resized linearly to 2 max(q, k) - 1 rows where it differs, the
    coordinates scaled by the sides' ratio."""
    rows = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != rows:
        rel_pos = F.interpolate(
            rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1),
            size=rows, mode="linear").reshape(-1, rows).permute(1, 0)
    q_coords = torch.arange(q_size, device=rel_pos.device)[:, None] * max(
        k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=rel_pos.device)[None, :] * max(
        q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


def window_partition(x: torch.Tensor, window: int):
    """(N, H, W, C) zero-padded to a multiple of ``window`` -> (N *
    windows, window, window, C) and the padded sides."""
    n, h, w, c = x.shape
    ph, pw = (-h) % window, (-w) % window
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(n, hp // window, window, wp // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c), \
        (hp, wp)


def window_unpartition(x: torch.Tensor, window: int, pad_hw, hw):
    hp, wp = pad_hw
    n = x.shape[0] // (hp * wp // window // window)
    x = x.reshape(n, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(n, hp, wp, -1)
    return x[:, :hw[0], :hw[1]]


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           rel_h: torch.Tensor, rel_w: torch.Tensor, q_hw, kv_hw
           ) -> torch.Tensor:
    """q (n, qh * qw, D), k and v (n, kh * kw, D) -> (n, qh * qw, D): the
    logits with ``add_decomposed_rel_pos``'s terms, softmax, times v."""
    n, _, d = q.shape
    attn = (q * d ** -0.5) @ k.transpose(-2, -1)
    rh = get_rel_pos(q_hw[0], kv_hw[0], rel_h)
    rw = get_rel_pos(q_hw[1], kv_hw[1], rel_w)
    r_q = q.reshape(n, q_hw[0], q_hw[1], d)
    bias_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
    bias_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
    attn = (attn.reshape(n, q_hw[0], q_hw[1], kv_hw[0], kv_hw[1])
            + bias_h[:, :, :, :, None] + bias_w[:, :, :, None, :]).reshape(
                n, q_hw[0] * q_hw[1], kv_hw[0] * kv_hw[1])
    return torch.softmax(attn, dim=-1) @ v


class MViT(MaskRCNN):
    """``MViT(weights, model)`` with ``model`` the configuration's model
    group (the ``mvit_*`` widths); ``quant`` rounds each conv/dense input
    and weight, as in ``MaskRCNN``."""

    preprocess = ViTDet.preprocess

    def __init__(self, weights: Dict[str, torch.Tensor], model: Dict,
                 quant: Optional[Quant] = None):
        # MaskRCNN's state, without its ResNet depth
        self.w = weights
        self.m = model
        self.q = quant or (lambda t: t)
        self.size = int(model["input_size"])
        dev = next(iter(weights.values())).device
        self.anchors = [a.to(dev) for a in pyramid_anchors(
            self.size, model["anchor_sizes"], model["anchor_ratios"])]
        self.specs = block_specs(model)
        self.last = [int(i) for i in model["mvit_last_block_indexes"]]

    def norm(self, x: torch.Tensor, key: str) -> torch.Tensor:
        return layer_norm(x, self.w[f"{key}/scale"], self.w[f"{key}/bias"])

    def pool(self, x: torch.Tensor, key: str, name: str,
             stride: int) -> torch.Tensor:
        """detectron2's ``attention_pool`` with its norm: (N, H, W, D) ->
        the depthwise 3 x 3 conv ``pool_{name}`` of ``stride`` (no bias,
        padding 1), then ``norm_{name}``."""
        k = self.w[f"{key}/pool_{name}/kernel"]            # (3, 3, 1, D)
        w = self.q(k.permute(3, 2, 0, 1).contiguous())
        y = F.conv2d(self.q(x.permute(0, 3, 1, 2)), w, stride=stride,
                     padding=1, groups=k.shape[-1])
        return self.norm(y.permute(0, 2, 3, 1), f"{key}/norm_{name}")

    def pooled_qkv(self, x: torch.Tensor, i: int):
        """Block ``i``'s pooled and normed q, k, v (B * heads, H', W', D)
        from its normed input (B, H, W, C)."""
        s = self.specs[i]
        key = f"{BOTTOM_UP}/blocks_{i}/attn"
        b, h, w, _ = x.shape
        qkv = self.dense(x, f"{key}/qkv").reshape(b, h, w, 3, s.heads, -1)
        qkv = qkv.permute(3, 0, 4, 1, 2, 5).reshape(3, b * s.heads, h, w, -1)
        q, k, v = qkv.unbind(0)
        return (self.pool(q, key, "q", s.stride_q),
                self.pool(k, key, "k", s.stride_kv),
                self.pool(v, key, "v", s.stride_kv))

    def block_attention(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """``MultiScaleAttention.forward`` of block ``i`` on its normed
        input (B, H, W, C) -> (B, H', W', C_out)."""
        s = self.specs[i]
        key = f"{BOTTOM_UP}/blocks_{i}/attn"
        b = x.shape[0]
        q, k, v = self.pooled_qkv(x, i)
        ori_q = q
        rh, rw = self.w[f"{key}/rel_pos_h"], self.w[f"{key}/rel_pos_w"]
        if s.window:
            qw, kw = s.window // s.stride_q, s.window // s.stride_kv
            q, q_pad = window_partition(q, qw)
            k, _ = window_partition(k, kw)
            v, _ = window_partition(v, kw)
            q_hw, kv_hw = (qw, qw), (kw, kw)
        else:
            q_hw, kv_hw = tuple(q.shape[1:3]), tuple(k.shape[1:3])
        n, d = q.shape[0], q.shape[-1]
        q = q.reshape(n, q_hw[0] * q_hw[1], d)
        k = k.reshape(n, kv_hw[0] * kv_hw[1], d)
        v = v.reshape(n, kv_hw[0] * kv_hw[1], d)
        step = n if s.window else 1         # one (image, head) when global
        out = torch.cat([attend(q[j:j + step], k[j:j + step],
                                v[j:j + step], rh, rw, q_hw, kv_hw)
                         for j in range(0, n, step)])
        out = out.reshape(n, q_hw[0], q_hw[1], d)
        if s.window:
            out = window_unpartition(out, q_hw[0], q_pad, ori_q.shape[1:3])
        out = out + ori_q
        hq, wq = out.shape[1:3]
        out = out.reshape(b, s.heads, hq, wq, d).permute(0, 2, 3, 1, 4)
        return self.dense(out.reshape(b, hq, wq, s.heads * d),
                          f"{key}/proj")

    def block(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """``MultiScaleBlock.forward`` of block ``i``."""
        s = self.specs[i]
        blk = f"{BOTTOM_UP}/blocks_{i}"
        x_norm = self.norm(x, f"{blk}/norm1")
        x_block = self.block_attention(x_norm, i)
        if s.dim != s.dim_out:
            x = self.dense(x_norm, f"{blk}/proj")
        if s.stride_q > 1:
            x = F.max_pool2d(x.permute(0, 3, 1, 2), s.stride_q + 1,
                             s.stride_q, (s.stride_q + 1) // 2).permute(
                                 0, 2, 3, 1)
        x = x + x_block
        y = F.gelu(self.dense(self.norm(x, f"{blk}/norm2"),
                              f"{blk}/mlp/fc1"))
        return x + self.dense(y, f"{blk}/mlp/fc2")

    def patch_embed(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, S, S) -> (B, S/4, S/4, C)."""
        k = self.w[f"{BOTTOM_UP}/patch_embed/proj/kernel"]    # HWIO
        y = F.conv2d(self.q(x), self.q(k.permute(3, 2, 0, 1).contiguous()),
                     self.w[f"{BOTTOM_UP}/patch_embed/proj/bias"],
                     stride=PATCH_STRIDE, padding=3)
        return y.permute(0, 2, 3, 1)

    def mvit(self, x: torch.Tensor) -> List[torch.Tensor]:
        """(B, 3, S, S) -> the four stages' normed outputs, NCHW."""
        x = self.patch_embed(x)
        outs = []
        for i in range(len(self.specs)):
            x = self.block(x, i)
            if i in self.last:
                y = self.norm(x, f"{BOTTOM_UP}/scale{len(outs) + 2}_norm")
                outs.append(y.permute(0, 3, 1, 2))
        return outs

    def backbone(self, x: torch.Tensor) -> List[torch.Tensor]:
        cs = self.mvit(x)
        lat = [self.conv(c, f"{FPN}/lateral{i + 2}") for i, c in enumerate(cs)]
        for i in range(len(lat) - 2, -1, -1):
            lat[i] = lat[i] + F.interpolate(lat[i + 1], scale_factor=2,
                                            mode="nearest")
        outs = [self.conv(t, f"{FPN}/output{i + 2}")
                for i, t in enumerate(lat)]
        outs.append(outs[-1][:, :, ::2, ::2])
        return outs
