"""Region Proposal Network: head + static-shape proposal selection.

Counterpart of ``treedetection_tpu/models/rpn.py``, batched over images:
per-level exact top-k (pre-NMS), per-level NMS, global post-NMS top-k.
Padded/invalid slots carry ``-inf`` scores.  Every top-k is a stable sort,
so ties break toward the lower index as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from treedetection_tpu_torch.models.layers import Conv2d
from treedetection_tpu_torch.ops.boxes import apply_deltas, clip_boxes
from treedetection_tpu_torch.ops.nms import nms_mask, stable_topk


class RPNHead(nn.Module):
    """Shared 3x3 conv(s) + 1x1 objectness / 1x1 anchor-delta heads.

    NHWC in and out: ``feats[l]`` (B, H, W, C) -> logits (B, H, W, A) and
    deltas (B, H, W, 4A).  ``num_convs`` 3x3 convs with ReLU: one is
    ``conv`` (the R-FPN head), more are ``conv.conv0``, ``conv.conv1``, ...
    (detectron2's ``conv_dims`` of several entries, as ViTDet's)."""

    def __init__(self, num_anchors: int = 3, features: int = 256,
                 num_convs: int = 1):
        super().__init__()
        if num_convs == 1:
            self.conv = Conv2d(features, features, 3, padding=1)
        else:
            self.conv = nn.Sequential()
            for i in range(num_convs):
                self.conv.add_module(f"conv{i}", Conv2d(
                    features, features, 3, padding=1))
        self.objectness_logits = Conv2d(features, num_anchors, 1)
        self.anchor_deltas = Conv2d(features, num_anchors * 4, 1)

    def _convs(self, t: torch.Tensor) -> torch.Tensor:
        for conv in (self.conv if isinstance(self.conv, nn.Sequential)
                     else (self.conv,)):
            t = F.relu(conv(t))
        return t

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        logits, regs = [], []
        for f in feats:
            t = self._convs(f.permute(0, 3, 1, 2))
            logits.append(self.objectness_logits(t).permute(0, 2, 3, 1))
            regs.append(self.anchor_deltas(t).permute(0, 2, 3, 1))
        return logits, regs


class Proposals(NamedTuple):
    boxes: torch.Tensor    # (B, K, 4)
    scores: torch.Tensor   # (B, K) objectness logit; -inf for padded slots


def generate_proposals(logits: Sequence[torch.Tensor],
                       deltas: Sequence[torch.Tensor],
                       anchors: Sequence[torch.Tensor],
                       image_size: int,
                       pre_nms_topk: int = 1000,
                       post_nms_topk: int = 1000,
                       nms_threshold: float = 0.7) -> Proposals:
    """Proposal selection for a batch.

    ``logits[l]``: (B, H, W, A); ``deltas[l]``: (B, H, W, 4A); ``anchors[l]``:
    (H*W*A, 4).  The levels are padded to one K and NMS runs per (image,
    level) in a single batched call.  Always exact top-k.
    """
    b = logits[0].shape[0]
    k_max = min(pre_nms_topk, max(an.shape[0] for an in anchors))
    level_boxes, level_scores = [], []
    for lg, dl, an in zip(logits, deltas, anchors):
        n = an.shape[0]
        scores = lg.reshape(b, n).float()
        d = dl.reshape(b, n, 4).float()
        k = min(pre_nms_topk, n)
        top_scores, idx = stable_topk(scores, k)
        d_top = torch.gather(d, 1, idx[..., None].expand(b, k, 4))
        boxes = clip_boxes(apply_deltas(d_top, an[idx]), image_size,
                           image_size)
        if k < k_max:
            boxes = F.pad(boxes, (0, 0, 0, k_max - k))
            top_scores = F.pad(top_scores, (0, k_max - k),
                               value=float("-inf"))
        level_boxes.append(boxes)
        level_scores.append(top_scores)

    lb = torch.stack(level_boxes, dim=1)                  # (B, L, K, 4)
    ls = torch.stack(level_scores, dim=1)                 # (B, L, K)
    keep = nms_mask(lb, ls, nms_threshold)
    all_boxes = lb.reshape(b, -1, 4)
    all_scores = torch.where(keep, ls, torch.full_like(ls, float("-inf")))
    top_scores, idx = stable_topk(all_scores.reshape(b, -1), post_nms_topk)
    return Proposals(
        boxes=torch.gather(all_boxes, 1,
                           idx[..., None].expand(b, idx.shape[1], 4)),
        scores=top_scores)
