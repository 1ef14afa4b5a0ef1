"""Plain Mask R-CNN ViTDet inference in float32, the benchmark's reference
for the ViTDet configuration.

detectron2's ``projects/ViTDet`` (``configs/common/models/
mask_rcnn_vitdet.py`` with the ViT-L backbone of ``configs/COCO/
mask_rcnn_vitdet_l_100ep.py``) at inference, written out in plain PyTorch
operations over a checkpoint in the Flax ``.npz`` layout
(``weights_vitdet.py``).  It is ``maskrcnn.MaskRCNN`` (anchors, proposals,
ROIAlign, box decoding, NMS, the detections' selection) with these parts
replaced:

* input: RGB uint8 tiles on a zero canvas, minus the pixel mean, over the
  pixel std, in RGB order, bilinear resize (half-pixel centres) to the
  model's square input;
* the ViT: a 16 x 16 / 16 patch conv with bias; the absolute position
  embedding without its class token, resized bicubically from 14 x 14 to
  the 64 x 64 token map (``align_corners=False``, detectron2's
  ``get_abs_pos``); blocks of LayerNorm (eps 1e-6), attention, residual,
  LayerNorm, MLP (exact GELU), residual; a windowed block pads the normed
  map with zeros to a multiple of the window and partitions it (its pad
  tokens take part in the attention, unmasked), the others attend over the
  whole map; every block adds the decomposed relative positions as
  ``add_decomposed_rel_pos`` does, with q unscaled; no final norm;
* the simple feature pyramid at scale factors 4, 2, 1, 0.5 (deconvs, a
  channel LayerNorm and GELU in the x4 branch, a 2 x 2 max-pool), each
  level a 1 x 1 and a 3 x 3 conv without bias, each with a channel
  LayerNorm (eps 1e-6); P6 = P5 subsampled;
* the RPN head's convs: as many 3 x 3 convs with ReLU as the checkpoint
  holds (two);
* the box head: four 3 x 3 convs without bias, each with a channel
  LayerNorm and ReLU, then one 1024-wide FC with ReLU;
* the mask head's four convs: without bias, each with a channel LayerNorm.

The attention logits are materialised in float32, one (image, head) at a
time in the global blocks, so that they fit.  Departures from detectron2,
each the deployment's, as in ``maskrcnn.py``: no minimum box size in the
RPN, the input resized on the device without aspect handling (tiles are
square), one class, 512 post-NMS proposals and a score threshold of 0.3.
It imports no code of the program under test.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from .maskrcnn import MaskRCNN, Quant, pyramid_anchors, roi_align

LN_EPS = 1e-6
NET = "params/backbone/net"
PYRAMID = "params/backbone/pyramid"


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis."""
    u = x.mean(-1, keepdim=True)
    s = (x - u).pow(2).mean(-1, keepdim=True)
    return (x - u) / torch.sqrt(s + LN_EPS) * scale + bias


def channel_norm(x: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """detectron2's ``LayerNorm`` over the channels of an NCHW map."""
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + LN_EPS)
    return scale[:, None, None] * x + bias[:, None, None]


def rel_pos(table: torch.Tensor, size: int) -> torch.Tensor:
    """(size, size, D): ``table[q - k + size - 1]`` (detectron2's
    ``get_rel_pos`` at the table's full length)."""
    coords = torch.arange(size, device=table.device)
    return table[coords[:, None] - coords[None, :] + size - 1]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              rel_h: torch.Tensor, rel_w: torch.Tensor, h: int,
              w: int) -> torch.Tensor:
    """One head over windows of h x w: q, k, v (n, h*w, D) -> (n, h*w, D),
    the logits ``scale q.k + q.Rh + q.Rw`` materialised."""
    n, t, d = q.shape
    attn = (q * d ** -0.5) @ k.transpose(-2, -1)
    rq = q.reshape(n, h, w, d)
    bias_h = torch.einsum("nhwc,hkc->nhwk", rq, rel_pos(rel_h, h))
    bias_w = torch.einsum("nhwc,wkc->nhwk", rq, rel_pos(rel_w, w))
    attn = (attn.reshape(n, h, w, h, w) + bias_h[:, :, :, :, None]
            + bias_w[:, :, :, None, :]).reshape(n, t, t)
    return torch.softmax(attn, dim=-1) @ v


class ViTDet(MaskRCNN):
    """``ViTDet(weights, model)`` with ``model`` the configuration's model
    group (``vit_*`` widths, ``vit_global_blocks``); ``quant`` rounds each
    conv/dense input and weight, as in ``MaskRCNN``."""

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
        self.heads = int(model["vit_heads"])
        self.window = int(model["vit_window"])
        self.global_blocks = {int(i) for i in model["vit_global_blocks"]}
        self.n_blocks = int(model["vit_depth"])
        self.rpn_convs = len({k.split("/")[3] for k in weights
                              if k.startswith("params/rpn_head/conv/conv")})

    # -- layers --------------------------------------------------------------
    def conv_ln(self, x: torch.Tensor, key: str) -> torch.Tensor:
        """Conv without bias, then its channel LayerNorm."""
        y = self.conv(x, key, bias=False)
        return channel_norm(y, self.w[f"{key}/norm/scale"],
                            self.w[f"{key}/norm/bias"])

    def deconv(self, x: torch.Tensor, key: str) -> torch.Tensor:
        """2x2 stride-2 transposed conv (Flax kernel (2, 2, in, out), the
        spatially flipped torch kernel) with bias."""
        k = self.q(self.w[f"{key}/kernel"].flip(0, 1))
        y = torch.einsum("nchw,abco->nohawb", self.q(x), k)
        n, o, h, _, w, _ = y.shape
        return y.reshape(n, o, 2 * h, 2 * w) + \
            self.w[f"{key}/bias"][:, None, None]

    def norm(self, x: torch.Tensor, key: str) -> torch.Tensor:
        return layer_norm(x, self.w[f"{key}/scale"], self.w[f"{key}/bias"])

    # -- the forward ---------------------------------------------------------
    def preprocess(self, tiles: torch.Tensor) -> torch.Tensor:
        """(B, P, P, 3) uint8 RGB -> (B, 3, S, S) normalized RGB."""
        mean = torch.tensor(self.m["pixel_mean"], dtype=torch.float32,
                            device=tiles.device)
        std = torch.tensor(self.m["pixel_std"], dtype=torch.float32,
                           device=tiles.device)
        x = (tiles.float() - mean) / std
        x = x.permute(0, 3, 1, 2)
        return F.interpolate(x, size=(self.size, self.size), mode="bilinear",
                             align_corners=False)

    def pos_embed(self, side: int) -> torch.Tensor:
        """(1, side, side, C): the position embedding at the token map."""
        pos = self.w[f"{NET}/pos_embed"][:, 1:]
        n = int(math.isqrt(pos.shape[1]))
        grid = pos.reshape(1, n, n, -1).permute(0, 3, 1, 2)
        if n != side:
            grid = F.interpolate(grid, size=(side, side), mode="bicubic",
                                 align_corners=False)
        return grid.permute(0, 2, 3, 1)

    def patch_embed(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, S, S) -> (B, S/p, S/p, C)."""
        k = self.w[f"{NET}/patch_embed/proj/kernel"]          # HWIO
        y = F.conv2d(self.q(x), self.q(k.permute(3, 2, 0, 1).contiguous()),
                     self.w[f"{NET}/patch_embed/proj/bias"],
                     stride=k.shape[0])
        return y.permute(0, 2, 3, 1)

    def block_attention(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """Block ``i``'s attention on the normed (B, H, W, C) map, with its
        output projection."""
        key = f"{NET}/blocks_{i}/attn"
        b, h, w, c = x.shape
        d = c // self.heads
        window = 0 if i in self.global_blocks else self.window
        if window:
            ph, pw = (-h) % window, (-w) % window
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
            hp, wp = h + ph, w + pw
            x = x.reshape(b, hp // window, window, wp // window, window, c)
            x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c)
            sh = sw = window
        else:
            sh, sw = h, w
        n = x.shape[0]
        qkv = self.dense(x.reshape(n, sh * sw, c), f"{key}/qkv")
        qkv = qkv.reshape(n, sh * sw, 3, self.heads, d).permute(2, 3, 0, 1, 4)
        out = torch.empty((self.heads, n, sh * sw, d), device=x.device)
        rh, rw = self.w[f"{key}/rel_pos_h"], self.w[f"{key}/rel_pos_w"]
        step = n if window else 1           # one (image, head) when global
        for head in range(self.heads):
            for s in range(0, n, step):
                sl = slice(s, s + step)
                out[head, sl] = attention(qkv[0, head, sl], qkv[1, head, sl],
                                          qkv[2, head, sl], rh, rw, sh, sw)
        out = out.permute(1, 2, 0, 3).reshape(n, sh * sw, c)
        out = self.dense(out, f"{key}/proj").reshape(n, sh, sw, c)
        if window:
            out = out.reshape(b, hp // window, wp // window, window, window, c)
            out = out.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
            out = out[:, :h, :w]
        return out

    def vit(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, S, S) -> the last map (B, C, S/16, S/16)."""
        x = self.patch_embed(x)
        x = x + self.pos_embed(x.shape[1])
        for i in range(self.n_blocks):
            blk = f"{NET}/blocks_{i}"
            x = x + self.block_attention(self.norm(x, f"{blk}/norm1"), i)
            y = self.norm(x, f"{blk}/norm2")
            y = F.gelu(self.dense(y, f"{blk}/mlp/fc1"))
            x = x + self.dense(y, f"{blk}/mlp/fc2")
        return x.permute(0, 3, 1, 2)

    def pyramid(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The simple feature pyramid: [P2..P6] from the stride-16 map."""
        up2 = self.deconv(x, f"{PYRAMID}/up2/deconv1")
        up2 = F.gelu(channel_norm(up2, self.w[f"{PYRAMID}/up2/norm/scale"],
                                  self.w[f"{PYRAMID}/up2/norm/bias"]))
        levels = [self.deconv(up2, f"{PYRAMID}/up2/deconv2"),
                  self.deconv(x, f"{PYRAMID}/up3/deconv1"),
                  x, F.max_pool2d(x, kernel_size=2, stride=2)]
        outs = [self.conv_ln(self.conv_ln(t, f"{PYRAMID}/lateral{i + 2}"),
                             f"{PYRAMID}/output{i + 2}")
                for i, t in enumerate(levels)]
        outs.append(outs[-1][:, :, ::2, ::2])
        return outs

    def backbone(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.pyramid(self.vit(x))

    def rpn(self, feats: Sequence[torch.Tensor]):
        out = []
        for f in feats:
            t = f
            for i in range(self.rpn_convs):
                t = F.relu(self.conv(t, f"params/rpn_head/conv/conv{i}"))
            lg = self.conv(t, "params/rpn_head/objectness_logits")
            dl = self.conv(t, "params/rpn_head/anchor_deltas")
            b = f.shape[0]
            out.append((lg.permute(0, 2, 3, 1).reshape(b, -1),
                        dl.permute(0, 2, 3, 1).reshape(b, -1, 4)))
        return out

    def box_features(self, feats, img: int,
                     boxes: torch.Tensor) -> torch.Tensor:
        """(N, 1024): the box head's FC, after its ReLU."""
        x = roi_align(feats, img, boxes, int(self.m["box_pool"]))
        for i in range(int(self.m["box_head_convs"])):
            x = F.relu(self.conv_ln(x, f"params/box_head/conv{i + 1}"))
        x = x.permute(0, 2, 3, 1).reshape(boxes.shape[0], -1)
        return F.relu(self.dense(x, "params/box_head/fc1"))

    def mask_features(self, feats, img: int,
                      boxes: torch.Tensor) -> torch.Tensor:
        """(N, C, 2R, 2R): the mask head before its predictor."""
        x = roi_align(feats, img, boxes, int(self.m["mask_pool"]))
        for i in range(4):
            x = F.relu(self.conv_ln(x, f"params/mask_head/mask_fcn{i + 1}"))
        return F.relu(self.deconv(x, "params/mask_head/deconv"))
