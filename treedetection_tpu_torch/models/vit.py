"""Plain-ViT backbone with a simple feature pyramid: the backbone of Mask
R-CNN ViTDet (Li et al., "Exploring Plain Vision Transformer Backbones for
Object Detection", arXiv:2203.16527; detectron2 ``modeling/backbone/vit.py``
and ``projects/ViTDet``).

Has no counterpart in the JAX package.  :class:`ViTDetBackbone` takes the
(B, S, S, 3) NHWC input like ``ResNetFPN`` and returns [P2..P6], each
(B, H_l, W_l, 256):

* the ViT: a 16 x 16 / 16 patch conv with bias; the absolute position
  embedding of the pretraining size (with its class token, which is
  dropped) resized bicubically to the token map, once, when the weights
  are set (:meth:`ViT.refresh_pos_embed`); pre-norm blocks (LayerNorm eps
  1e-6, qkv bias, MLP with exact GELU), each attending within square
  windows of the map or, in the blocks of ``global_blocks``, over the whole
  map, with decomposed relative positions in every block
  (``ops.kernels.relpos_attention``: one kernel launch a block on the card);
  no final norm;
* the simple feature pyramid from the last (stride 16) map, scale factors
  4, 2, 1 and 0.5 (two 2 x 2 deconvs with a channel LayerNorm and GELU
  between them; one deconv; the map; a 2 x 2 max-pool), each level then a
  1 x 1 and a 3 x 3 conv without bias, each followed by a channel
  LayerNorm; P6 is P5 subsampled by 2 (detectron2's ``LastLevelMaxPool``).

A windowed block runs the qkv projection over the unpadded map; the
kernel reads the qkv bias for detectron2's zero pads (their q, k and v), so
that the block's output on the map is detectron2's.

While tracing is on (``utils.profiling``), the backbone opens the spans
``vit.embed``, ``vit.window_blocks``, ``vit.global_blocks`` (one per run of
consecutive blocks of a kind) and ``vit.pyramid``.  The map is NHWC
throughout: tokens are its pixels, the convs run on its channels_last view.
"""

from __future__ import annotations

import math
from itertools import groupby
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from treedetection_tpu_torch.models.layers import (
    Conv2d, ConvLN, ConvTranspose2d, LayerNorm, LayerNorm2d, Linear)
from treedetection_tpu_torch.ops.kernels.relpos_attention import (
    relpos_attention)
from treedetection_tpu_torch.utils.profiling import span

LN_EPS = 1e-6
PYRAMID_SCALES = (4.0, 2.0, 1.0, 0.5)


class Attention(nn.Module):
    """Multi-head attention with decomposed relative positions over a
    (B, H, W, C) map; ``window`` 0 attends over the whole map of
    ``input_size``."""

    def __init__(self, dim: int, num_heads: int, window: int,
                 input_size: Tuple[int, int]):
        super().__init__()
        self.num_heads = num_heads
        self.window = window
        head_dim = dim // num_heads
        sh, sw = (window, window) if window else input_size
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * sh - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * sw - 1, head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = self.qkv(x)
        dt = qkv.dtype
        out = relpos_attention(qkv, self.qkv.bias.to(dt),
                               self.rel_pos_h.to(dt), self.rel_pos_w.to(dt),
                               self.num_heads, self.window)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """Pre-norm transformer block on a (B, H, W, C) map."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 window: int, input_size: Tuple[int, int]):
        super().__init__()
        self.window = window
        self.norm1 = LayerNorm(dim, LN_EPS)
        self.attn = Attention(dim, num_heads, window, input_size)
        self.norm2 = LayerNorm(dim, LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = Conv2d(3, dim, patch, stride=patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) -> (B, S / p, S / p, dim)."""
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return self.proj(x).permute(0, 2, 3, 1)


class ViT(nn.Module):
    """The plain ViT: patch embedding, position embedding, blocks."""

    def __init__(self, img_size: int = 1024, patch: int = 16,
                 dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 mlp_ratio: float = 4.0, window: int = 14,
                 global_blocks: Sequence[int] = (5, 11, 17, 23),
                 pretrain_img_size: int = 224):
        super().__init__()
        self.grid = img_size // patch
        self.patch_embed = PatchEmbed(patch, dim)
        n_pos = (pretrain_img_size // patch) ** 2 + 1      # + class token
        self.pos_embed = nn.Parameter(torch.zeros(1, n_pos, dim))
        self.blocks = nn.ModuleList(
            Block(dim, num_heads, mlp_ratio,
                  0 if i in global_blocks else window,
                  (self.grid, self.grid)) for i in range(depth))
        # the position embedding at the map's size: a constant of the
        # weights, set whenever they are (module state, not a checkpoint
        # entry)
        self.register_buffer("pos_embed_map", torch.zeros(
            1, self.grid, self.grid, dim), persistent=False)
        self.register_load_state_dict_post_hook(
            lambda module, _: module.refresh_pos_embed())
        self.refresh_pos_embed()

    @torch.no_grad()
    def refresh_pos_embed(self) -> None:
        """``pos_embed_map`` from ``pos_embed``: the class token dropped,
        the pretraining grid resized bicubically (``align_corners=False``)
        to the token map, in float32 (detectron2's ``get_abs_pos``)."""
        pos = self.pos_embed.detach().float()[:, 1:]
        side = int(math.isqrt(pos.shape[1]))
        grid = pos.reshape(1, side, side, -1).permute(0, 3, 1, 2)
        if side != self.grid:
            grid = F.interpolate(grid, size=(self.grid, self.grid),
                                 mode="bicubic", align_corners=False)
        self.pos_embed_map.copy_(grid.permute(0, 2, 3, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) -> the last map (B, S / 16, S / 16, dim)."""
        with span("vit.embed"):
            x = self.patch_embed(x)
            x = x + self.pos_embed_map.to(x.dtype)
        kinds = [(b.window == 0, b) for b in self.blocks]
        for is_global, run in groupby(kinds, key=lambda kb: kb[0]):
            with span("vit.global_blocks" if is_global
                      else "vit.window_blocks"):
                for _, block in run:
                    x = block(x)
        return x


class _Upsample(nn.Module):
    """x2: a deconv 2x2/2 dim -> dim/2; x4: that deconv, a channel
    LayerNorm, GELU and a deconv 2x2/2 dim/2 -> dim/4."""

    def __init__(self, dim: int, factor: int):
        super().__init__()
        self.deconv1 = ConvTranspose2d(dim, dim // 2, 2, stride=2)
        if factor == 4:
            self.norm = LayerNorm2d(dim // 2, LN_EPS)
            self.deconv2 = ConvTranspose2d(dim // 2, dim // 4, 2, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.deconv1(x)
        if hasattr(self, "deconv2"):
            x = self.deconv2(F.gelu(self.norm(x)))
        return x


class SimpleFeaturePyramid(nn.Module):
    """[P2..P6] from one stride-16 NCHW map; ``out`` channels each."""

    def __init__(self, dim: int = 1024, out: int = 256):
        super().__init__()
        widths = {4.0: dim // 4, 2.0: dim // 2, 1.0: dim, 0.5: dim}
        for scale in PYRAMID_SCALES:
            level = int(4 - math.log2(scale))
            if scale > 1.0:
                self.add_module(f"up{level}", _Upsample(dim, int(scale)))
            self.add_module(f"lateral{level}", ConvLN(widths[scale], out, 1))
            self.add_module(f"output{level}", ConvLN(out, out, 3))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for scale in PYRAMID_SCALES:
            level = int(4 - math.log2(scale))
            if scale > 1.0:
                t = getattr(self, f"up{level}")(x)
            elif scale == 0.5:
                t = F.max_pool2d(x, kernel_size=2, stride=2)
            else:
                t = x
            t = getattr(self, f"lateral{level}")(t)
            outs.append(getattr(self, f"output{level}")(t))
        outs.append(outs[-1][:, :, ::2, ::2])
        return outs


class ViTDetBackbone(nn.Module):
    """(B, S, S, 3) NHWC -> [P2, P3, P4, P5, P6], each (B, H_l, W_l, out)."""

    def __init__(self, img_size: int = 1024, patch: int = 16,
                 dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 mlp_ratio: float = 4.0, window: int = 14,
                 global_blocks: Sequence[int] = (5, 11, 17, 23),
                 out: int = 256):
        super().__init__()
        self.net = ViT(img_size, patch, dim, depth, num_heads, mlp_ratio,
                       window, global_blocks)
        self.pyramid = SimpleFeaturePyramid(dim, out)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.net(x)
        with span("vit.pyramid"):
            feats = self.pyramid(x.permute(0, 3, 1, 2))
            return [f.permute(0, 2, 3, 1) for f in feats]
