"""Mask pasting: R x R head outputs -> full-tile binary masks.

Counterpart of ``treedetection_tpu/ops/masks.py`` (detectron2's
``paste_masks_in_image`` semantics): each soft mask is sampled bilinearly at
the pixel centres inside its box (align_corners=False) and thresholded.  All
boxes at once, as gathers over (N, H, W) index grids.
"""

from __future__ import annotations

import torch


def paste_masks_in_image(masks: torch.Tensor, boxes: torch.Tensor,
                         out_h: int, out_w: int,
                         threshold: float = 0.5) -> torch.Tensor:
    """(N, R, R) soft masks + (N, 4) boxes -> (N, out_h, out_w) bool masks.

    Each output pixel centre (x, y) inside a box samples that box's mask at
    its normalized position in the box."""
    n, r = masks.shape[0], masks.shape[-1]
    dev = masks.device
    ys = torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5
    x0, y0, x1, y1 = (boxes[:, k:k + 1] for k in range(4))     # (N, 1)
    w = torch.clamp(x1 - x0, min=1e-3)
    h = torch.clamp(y1 - y0, min=1e-3)
    my = (ys - y0) / h * r - 0.5                               # (N, H)
    mx = (xs - x0) / w * r - 0.5                               # (N, W)
    inside = ((ys >= y0) & (ys <= y1))[:, :, None] & \
        ((xs >= x0) & (xs <= x1))[:, None, :]
    myc = torch.clamp(my, 0.0, r - 1.0)
    mxc = torch.clamp(mx, 0.0, r - 1.0)
    iy0 = torch.floor(myc).long()
    ix0 = torch.floor(mxc).long()
    iy1 = torch.clamp(iy0 + 1, max=r - 1)
    ix1 = torch.clamp(ix0 + 1, max=r - 1)
    ly = (myc - iy0)[:, :, None]
    lx = (mxc - ix0)[:, None, :]
    b = torch.arange(n, device=dev)[:, None, None]

    def at(iy, ix):
        return masks[b, iy[:, :, None], ix[:, None, :]]

    val = (at(iy0, ix0) * (1 - ly) * (1 - lx) + at(iy0, ix1) * (1 - ly) * lx
           + at(iy1, ix0) * ly * (1 - lx) + at(iy1, ix1) * ly * lx)
    return (val > threshold) & inside


def mask_areas(masks: torch.Tensor) -> torch.Tensor:
    """(N, H, W) -> (N,) pixel areas."""
    return masks.sum(dim=(-2, -1))
