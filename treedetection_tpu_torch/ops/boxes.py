"""Box math: IoU matrices, delta decoding, clipping.

Counterpart of ``treedetection_tpu/ops/boxes.py``.  Boxes are
``[x0, y0, x1, y1]`` in the last dimension; every function accepts leading
batch dimensions.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

# largest box scale change exp(d) allowed — detectron2's clamp log(1000/16)
_SCALE_CLAMP = math.log(1000.0 / 16.0)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0))


def box_iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, M) IoU of two box sets (0 where the union is 0)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def pairwise_intersection_over_area(a: torch.Tensor,
                                    b: torch.Tensor) -> torch.Tensor:
    """(N, M) intersection / area(a): the containment ratio of the crown
    containment relation (0 where area(a) is 0)."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    area = box_area(a)[:, None]
    return torch.where(area > 0, inter / area, torch.zeros_like(inter))


def apply_deltas(deltas: torch.Tensor, boxes: torch.Tensor,
                 weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
                 ) -> torch.Tensor:
    """Decode (dx, dy, dw, dh) regression deltas onto boxes (detectron2
    ``Box2BoxTransform.apply_deltas``: weights and scale clamp)."""
    wx, wy, ww, wh = weights
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=_SCALE_CLAMP)
    dh = torch.clamp(deltas[..., 3] / wh, max=_SCALE_CLAMP)

    pred_ctr_x = dx * widths + ctr_x
    pred_ctr_y = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack([
        pred_ctr_x - 0.5 * pred_w,
        pred_ctr_y - 0.5 * pred_h,
        pred_ctr_x + 0.5 * pred_w,
        pred_ctr_y + 0.5 * pred_h,
    ], dim=-1)


def encode_deltas(src: torch.Tensor, target: torch.Tensor,
                  weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
                  ) -> torch.Tensor:
    """Inverse of :func:`apply_deltas` (the training targets)."""
    wx, wy, ww, wh = weights
    sw = src[..., 2] - src[..., 0]
    sh = src[..., 3] - src[..., 1]
    sx = src[..., 0] + 0.5 * sw
    sy = src[..., 1] + 0.5 * sh
    tw = target[..., 2] - target[..., 0]
    th = target[..., 3] - target[..., 1]
    tx = target[..., 0] + 0.5 * tw
    ty = target[..., 1] + 0.5 * th
    eps = 1e-7
    return torch.stack([
        wx * (tx - sx) / torch.clamp(sw, min=eps),
        wy * (ty - sy) / torch.clamp(sh, min=eps),
        ww * torch.log(torch.clamp(tw, min=eps) / torch.clamp(sw, min=eps)),
        wh * torch.log(torch.clamp(th, min=eps) / torch.clamp(sh, min=eps)),
    ], dim=-1)


def clip_boxes(boxes: torch.Tensor, height: float, width: float) -> torch.Tensor:
    return torch.stack([
        torch.clamp(boxes[..., 0], 0, width),
        torch.clamp(boxes[..., 1], 0, height),
        torch.clamp(boxes[..., 2], 0, width),
        torch.clamp(boxes[..., 3], 0, height),
    ], dim=-1)


def transform_pixel_to_geo(coords: torch.Tensor,
                           affine: torch.Tensor) -> torch.Tensor:
    """Batch pixel -> geo transform on the tensor's device: ``coords``
    (..., 2) as (col, row), ``affine`` the 6-vector (a, b, c, d, e, f)."""
    a, b, c, d, e, f = (affine[i] for i in range(6))
    x = a * coords[..., 0] + b * coords[..., 1] + c
    y = d * coords[..., 0] + e * coords[..., 1] + f
    return torch.stack([x, y], dim=-1)
