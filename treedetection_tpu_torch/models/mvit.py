"""Multiscale vision transformer backbone with an FPN: the backbone of Mask
R-CNN MViTv2 (Li et al., "MViTv2: Improved Multiscale Vision Transformers
for Classification and Detection", arXiv:2112.01526; detectron2
``modeling/backbone/mvit.py`` and ``projects/MViTv2``).

Has no counterpart in the JAX package.  :class:`MViTBackbone` takes the
(B, S, S, 3) NHWC input like ``ResNetFPN`` and returns [P2..P6], each
(B, H_l, W_l, 256):

* a 7 x 7 / 4 patch conv with bias (padding 3), no norm, no position
  embedding;
* four stages of pre-norm blocks (LayerNorm eps 1e-6, exact GELU).  A block
  projects the normed map to q, k and v, pools each by its own depthwise
  3 x 3 conv over the head's channels (q at stride 1, or 2 in a stage's
  first block; k and v at the stage's kv stride) and norms it, and attends
  within windows of the pooled maps (each map its own window side) or, in
  the last block of each stage after the first, over the whole maps, with
  the decomposed relative positions of detectron2's ``get_rel_pos`` in
  every block and the pooled q added to the output (residual pooling)
  (``ops.kernels.relpos_attention.pooled_attention``: one kernel launch a
  block on the card).  The skip is the input, or its projection of the
  normed input where the width doubles, max-pooled 3 x 3 / 2 where q is
  pooled;
* each stage's output through its own LayerNorm (``scale{k}_norm``) into
  the port's ``FPN`` (P6 = P5 subsampled by 2).

Each block's tables are read at the rows its windows (or, in a global
block, its maps at the model's input size) need; where the stored table
has another length it is resized linearly, once, when the weights are set
(:meth:`MultiScaleAttention.refresh_tables`), never in the forward.

While tracing is on (``utils.profiling``), the backbone opens the spans
``mvit.embed``, ``mvit.window_blocks``, ``mvit.global_blocks`` (one per run
of consecutive blocks of a kind) and ``mvit.fpn``.  The map is NHWC
throughout: tokens are its pixels; the convs and the skip's max-pool run on
its channels_last view.
"""

from __future__ import annotations

from itertools import groupby
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from treedetection_tpu_torch.models.layers import Conv2d, LayerNorm, Linear
from treedetection_tpu_torch.models.resnet import FPN
from treedetection_tpu_torch.models.vit import LN_EPS, Mlp
from treedetection_tpu_torch.ops.kernels.relpos_attention import (
    LIBRARY, pooled_attention, resize_table, table_rows)
from treedetection_tpu_torch.utils.profiling import span

PATCH_STRIDE = 4


def _pooled(side: int, stride: int) -> int:
    """A map side after a 3 x 3 conv (or max-pool) of ``stride``, padding 1."""
    return -(-side // stride)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """The channels_last NCHW view of an NHWC map."""
    return x.permute(0, 3, 1, 2)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = Conv2d(3, dim, 7, stride=PATCH_STRIDE, padding=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) -> (B, S / 4, S / 4, dim)."""
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return self.proj(x).permute(0, 2, 3, 1)


class MultiScaleAttention(nn.Module):
    """Pooling attention of one block over a normed (B, H, W, C_in) map of
    side ``side`` at the model's input size."""

    def __init__(self, dim: int, dim_out: int, num_heads: int,
                 stride_q: int, stride_kv: int, window: int,
                 pretrain_side: int, side: int):
        super().__init__()
        self.num_heads = num_heads
        d = dim_out // num_heads
        self.head_dim = d
        self.qkv = Linear(dim, 3 * dim_out)
        self.proj = Linear(dim_out, dim_out)
        for name, stride in (("q", stride_q), ("k", stride_kv),
                             ("v", stride_kv)):
            self.add_module(f"pool_{name}", Conv2d(
                d, d, 3, stride=stride, padding=1, groups=d, bias=False))
            self.add_module(f"norm_{name}", LayerNorm(d, LN_EPS))
        self.q_window = window // stride_q if window else 0
        self.kv_window = window // stride_kv if window else 0
        rows = table_rows(pretrain_side // stride_q,
                          pretrain_side // stride_kv)
        self.rel_pos_h = nn.Parameter(torch.zeros(rows, d))
        self.rel_pos_w = nn.Parameter(torch.zeros(rows, d))
        # the rows the attention reads at the model's input size: the
        # windows' sides, or the pooled maps' in a global block
        q_side = self.q_window or _pooled(side, stride_q)
        kv_side = self.kv_window or _pooled(side, stride_kv)
        used = table_rows(q_side, kv_side)
        # the tables at those rows: constants of the weights, set whenever
        # they are (module state, not checkpoint entries)
        self.register_buffer("rel_h_used", torch.zeros(used, d),
                             persistent=False)
        self.register_buffer("rel_w_used", torch.zeros(used, d),
                             persistent=False)

    @torch.no_grad()
    def refresh_tables(self) -> None:
        """``rel_h_used`` and ``rel_w_used`` from the stored tables, resized
        linearly in float32 where their lengths differ (detectron2's
        ``get_rel_pos``)."""
        for stored, used in ((self.rel_pos_h, self.rel_h_used),
                             (self.rel_pos_w, self.rel_w_used)):
            used.copy_(resize_table(stored.detach(), used.shape[0]))

    def _pool(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """(B * heads, H, W, D) -> pooled and normed (B * heads, H', W', D)."""
        x = getattr(self, f"pool_{name}")(_nchw(x)).permute(0, 2, 3, 1)
        return getattr(self, f"norm_{name}")(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        heads, d = self.num_heads, self.head_dim
        # detectron2's channel order (3, heads, D), each (B * heads, H, W, D)
        qkv = self.qkv(x).reshape(b, h, w, 3, heads, d).permute(
            3, 0, 4, 1, 2, 5).reshape(3, b * heads, h, w, d)
        q, k, v = (self._pool(qkv[i], name) for i, name in enumerate("qkv"))
        dt = q.dtype
        out = pooled_attention(q, k, v, self.rel_h_used.to(dt),
                               self.rel_w_used.to(dt), heads, self.q_window,
                               self.kv_window)
        return self.proj(out)


class MultiScaleBlock(nn.Module):
    """Pre-norm MViTv2 block on a (B, H, W, C_in) map -> (B, H', W',
    C_out)."""

    def __init__(self, dim: int, dim_out: int, num_heads: int,
                 mlp_ratio: float, stride_q: int, stride_kv: int,
                 window: int, pretrain_side: int, side: int):
        super().__init__()
        self.window = window
        self.stride_q = stride_q
        self.norm1 = LayerNorm(dim, LN_EPS)
        self.attn = MultiScaleAttention(dim, dim_out, num_heads, stride_q,
                                        stride_kv, window, pretrain_side,
                                        side)
        self.norm2 = LayerNorm(dim_out, LN_EPS)
        self.mlp = Mlp(dim_out, int(dim_out * mlp_ratio))
        if dim != dim_out:
            self.proj = Linear(dim, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_norm = self.norm1(x)
        x_block = self.attn(x_norm)
        if hasattr(self, "proj"):
            x = self.proj(x_norm)
        if self.stride_q > 1:
            x = F.max_pool2d(_nchw(x), kernel_size=self.stride_q + 1,
                             stride=self.stride_q,
                             padding=(self.stride_q + 1) // 2).permute(
                                 0, 2, 3, 1)
        x = x + x_block
        return x + self.mlp(self.norm2(x))


class MViT(nn.Module):
    """The patch embedding and the blocks; ``forward`` -> the four stages'
    normed outputs, NHWC (strides 4, 8, 16, 32)."""

    def __init__(self, img_size: int = 1024, embed_dim: int = 96,
                 depth: int = 10, num_heads: int = 1,
                 last_block_indexes: Sequence[int] = (0, 2, 7, 9),
                 mlp_ratio: float = 4.0, window: int = 56,
                 kv_stride: int = 4, pretrain_size: int = 224):
        super().__init__()
        last = tuple(last_block_indexes)
        self.last_block_indexes = last
        self.patch_embed = PatchEmbed(embed_dim)
        # detectron2's MViT.__init__: the kv stride doubled in the last
        # block of stages 3 and 4, which attend globally (as does stage
        # 5's); width and heads doubled, kv stride halved after each
        # stage's last block; q pooled 2x by the next stage's first block,
        # after which the window and the pretraining map halve
        dim, dim_out, heads = embed_dim, embed_dim, num_heads
        pretrain_side = pretrain_size // PATCH_STRIDE
        side = _pooled(img_size, PATCH_STRIDE)
        self.blocks = nn.ModuleList()
        self.widths: List[int] = []
        for i in range(depth):
            stride_q = 2 if i - 1 in last else 1
            self.blocks.append(MultiScaleBlock(
                dim, dim_out, heads, mlp_ratio, stride_q,
                kv_stride * 2 if i in last[1:3] else kv_stride,
                0 if i in last[1:] else window, pretrain_side, side))
            side = _pooled(side, stride_q)
            dim = dim_out
            if i in last:
                self.add_module(f"scale{len(self.widths) + 2}_norm",
                                LayerNorm(dim_out, LN_EPS))
                self.widths.append(dim_out)
                dim_out, heads = dim_out * 2, heads * 2
                kv_stride = max(kv_stride // 2, 1)
            if i - 1 in last:
                window //= 2
                pretrain_side //= 2
        self.register_load_state_dict_post_hook(
            lambda module, _: module.refresh_tables())
        self.refresh_tables()

    def refresh_tables(self) -> None:
        for block in self.blocks:
            block.attn.refresh_tables()

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """(B, S, S, 3) -> [stage 2..5 maps (B, H_s, W_s, C_s)]."""
        with span("mvit.embed"):
            x = self.patch_embed(x)
        outs = []
        kinds = [(b.window == 0, i, b) for i, b in enumerate(self.blocks)]
        for is_global, run in groupby(kinds, key=lambda kb: kb[0]):
            with span("mvit.global_blocks" if is_global
                      else "mvit.window_blocks"):
                for _, i, block in run:
                    x = block(x)
                    if i in self.last_block_indexes:
                        norm = getattr(self, f"scale{len(outs) + 2}_norm")
                        outs.append(norm(x))
        return outs


class MViTBackbone(nn.Module):
    """(B, S, S, 3) NHWC -> [P2, P3, P4, P5, P6], each (B, H_l, W_l, out)."""

    libraries = (LIBRARY,)     # the attention kernel's, launched on the card

    def __init__(self, img_size: int = 1024, embed_dim: int = 96,
                 depth: int = 10, num_heads: int = 1,
                 last_block_indexes: Sequence[int] = (0, 2, 7, 9),
                 mlp_ratio: float = 4.0, window: int = 56,
                 kv_stride: int = 4, pretrain_size: int = 224,
                 out: int = 256):
        super().__init__()
        self.bottom_up = MViT(img_size, embed_dim, depth, num_heads,
                              last_block_indexes, mlp_ratio, window,
                              kv_stride, pretrain_size)
        self.fpn = FPN(in_features=self.bottom_up.widths, features=out)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = self.bottom_up(x)
        with span("mvit.fpn"):
            feats = self.fpn([_nchw(f) for f in feats])
            return [f.permute(0, 2, 3, 1) for f in feats]
