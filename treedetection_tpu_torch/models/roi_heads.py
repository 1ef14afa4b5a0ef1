"""ROI heads: box head (2-FC classifier/regressor), mask head, and the
static-shape detection selection.

Counterpart of ``treedetection_tpu/models/roi_heads.py`` (detectron2
``StandardROIHeads``: class-specific box regression with weights 10/10/5/5,
4-conv + deconv mask head), batched over images.  Pooled features arrive in
the JAX package's (N, R, R, C) layout, so ``fc1`` reads its input in HWC
order.

ViTDet's heads (no counterpart in the JAX package) are selected by
arguments: the box head's ``num_convs`` 3x3 convs before one FC
(detectron2's ``FastRCNNConvFCHead`` "4conv1fc"), and ``norm="LN"``, which
gives each conv of either head a channel LayerNorm (``norm``) and no bias.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from treedetection_tpu_torch.models.layers import (
    Conv2d, ConvLN, ConvTranspose2d, Linear)
from treedetection_tpu_torch.ops.boxes import apply_deltas, clip_boxes
from treedetection_tpu_torch.ops.nms import nms_mask, stable_topk

BOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


def _head_conv(features: int, norm: str) -> Conv2d:
    """A 3x3 conv of the heads: with bias, or with ``norm`` "LN" without
    bias and followed by its channel LayerNorm."""
    if norm not in ("", "LN"):
        raise ValueError(f"unknown head norm {norm!r}")
    return (ConvLN(features, features, 3) if norm
            else Conv2d(features, features, 3, padding=1))


class BoxHead(nn.Module):
    """[``num_convs`` x (3x3 conv + relu)] -> flatten -> FC 1024 [-> FC
    1024] -> (cls logits, per-class box deltas), both returned in float32.
    Without convs: two FCs (the R-FPN heads); with convs: one FC
    (ViTDet's 4conv1fc), the convs' output flattened in HWC order."""

    def __init__(self, in_features: int = 256 * 7 * 7, num_classes: int = 1,
                 fc_dim: int = 1024, num_convs: int = 0, features: int = 256,
                 norm: str = ""):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"conv{i + 1}", _head_conv(features, norm))
        self.fc1 = Linear(in_features, fc_dim)
        if not num_convs:
            self.fc2 = Linear(fc_dim, fc_dim)
        self.cls_score = Linear(fc_dim, num_classes + 1)
        self.bbox_pred = Linear(fc_dim, num_classes * 4)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.num_convs:
            x = x.permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
            for i in range(self.num_convs):
                x = F.relu(getattr(self, f"conv{i + 1}")(x))
            x = x.permute(0, 2, 3, 1)
        x = F.relu(self.fc1(x.reshape(x.shape[0], -1)))
        if not self.num_convs:
            x = F.relu(self.fc2(x))
        return self.cls_score(x).float(), self.bbox_pred(x).float()


class MaskHead(nn.Module):
    """4x (3x3 conv 256 [+ channel LayerNorm] + relu) -> 2x deconv -> 1x1
    per-class mask logits.  (N, R, R, C) NHWC in, (N, 2R, 2R, num_classes)
    float32 out."""

    def __init__(self, num_classes: int = 1, features: int = 256,
                 norm: str = ""):
        super().__init__()
        for i in range(4):
            self.add_module(f"mask_fcn{i + 1}", _head_conv(features, norm))
        self.deconv = ConvTranspose2d(features, features, 2, stride=2)
        self.predictor = Conv2d(features, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        for i in range(4):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        x = F.relu(self.deconv(x))
        return self.predictor(x).permute(0, 2, 3, 1).float()


class Detections(NamedTuple):
    boxes: torch.Tensor    # (B, D, 4)
    scores: torch.Tensor   # (B, D) softmax prob; 0 for padded slots
    classes: torch.Tensor  # (B, D) int32
    valid: torch.Tensor    # (B, D) bool
    src: torch.Tensor      # (B, D) int64 — index of the source proposal


def box_inference(cls_logits: torch.Tensor, box_deltas: torch.Tensor,
                  proposals: torch.Tensor, proposal_scores: torch.Tensor,
                  image_size: int, score_threshold: float,
                  nms_threshold: float, max_detections: int) -> Detections:
    """detectron2 ``fast_rcnn_inference`` with static shapes, single class.

    ``cls_logits`` (B, K, C+1); ``box_deltas`` (B, K, 4C); ``proposals``
    (B, K, 4); ``proposal_scores`` (B, K).  The final top-k is a stable sort,
    so ``-inf`` padding slots take the lowest free indices as in JAX.
    """
    probs = torch.softmax(cls_logits, dim=-1)[..., 0]   # foreground class 0
    boxes = apply_deltas(box_deltas[..., :4], proposals, BOX_REG_WEIGHTS)
    boxes = clip_boxes(boxes, image_size, image_size)

    neg_inf = torch.full_like(probs, float("-inf"))
    score_ok = (probs > score_threshold) & (proposal_scores > float("-inf"))
    keep = nms_mask(boxes, torch.where(score_ok, probs, neg_inf),
                    nms_threshold)
    final = torch.where(keep & score_ok, probs, neg_inf)
    top_scores, idx = stable_topk(final, max_detections)
    valid = top_scores > float("-inf")
    b, d = idx.shape
    return Detections(
        boxes=torch.gather(boxes, 1, idx[..., None].expand(b, d, 4)),
        scores=torch.where(valid, top_scores, torch.zeros_like(top_scores)),
        classes=torch.zeros((b, d), dtype=torch.int32, device=idx.device),
        valid=valid,
        src=idx,
    )
