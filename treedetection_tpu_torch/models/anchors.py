"""Anchor generation for the RPN — detectron2 ``DefaultAnchorGenerator``
conventions (offset 0, base anchors centered on the grid points).

Counterpart of ``treedetection_tpu/models/anchors.py``; the grids are numpy
(float32, the same ops in the same order) and the model uploads them once.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np


def base_anchors(size: float, ratios: Sequence[float]) -> np.ndarray:
    """(A, 4) anchors centered at (0, 0) with the given area and aspect ratios."""
    out = []
    area = size * size
    for r in ratios:
        w = math.sqrt(area / r)
        h = w * r
        out.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(out, dtype=np.float32)


def grid_anchors(feat_h: int, feat_w: int, stride: int, size: float,
                 ratios: Sequence[float]) -> np.ndarray:
    """(H*W*A, 4) anchors for one FPN level (row-major grid, anchors fastest)."""
    base = base_anchors(size, ratios)                        # (A, 4)
    shifts_x = np.arange(feat_w, dtype=np.float32) * stride
    shifts_y = np.arange(feat_h, dtype=np.float32) * stride
    sx, sy = np.meshgrid(shifts_x, shifts_y)                 # (H, W)
    shifts = np.stack([sx, sy, sx, sy], axis=-1)             # (H, W, 4)
    anchors = shifts[:, :, None, :] + base[None, None, :, :]  # (H, W, A, 4)
    return anchors.reshape(-1, 4)


def pyramid_anchors(input_size: int,
                    strides: Sequence[int] = (4, 8, 16, 32, 64),
                    sizes: Sequence[float] = (32, 64, 128, 256, 512),
                    ratios: Sequence[float] = (0.5, 1.0, 2.0)
                    ) -> List[np.ndarray]:
    """Anchors for every FPN level of a square ``input_size`` image."""
    out = []
    for stride, size in zip(strides, sizes):
        fh = fw = int(math.ceil(input_size / stride))
        out.append(grid_anchors(fh, fw, stride, size, ratios))
    return out
