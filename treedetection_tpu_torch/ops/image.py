"""Image preprocessing on the device: BGR normalization, bilinear resize,
16-bit rescale and NDVI.

Counterpart of ``treedetection_tpu/ops/image.py``.  The resize keeps the
JAX package's half-pixel interpolation matrices, applied as two matmuls.
Every op runs on the device of the tensor it is given.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from treedetection_tpu_torch.utils.profiling import span

_INTERP_CACHE: Dict[Tuple[int, int, torch.dtype, torch.device], torch.Tensor] = {}


def _interp_matrix_np(out_size: int, in_size: int) -> np.ndarray:
    """(out, in) bilinear interpolation matrix, half-pixel centers
    (align_corners=False)."""
    src = (np.arange(out_size) + 0.5) * in_size / out_size - 0.5
    i0 = np.clip(np.floor(src).astype(int), 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    frac = np.clip(src - i0, 0.0, 1.0)
    m = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, i0), 1.0 - frac)
    np.add.at(m, (rows, i1), frac)
    return m


def _interp_matrix(out_size: int, in_size: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    key = (out_size, in_size, dtype, device)
    m = _INTERP_CACHE.get(key)
    if m is None:
        m = torch.from_numpy(_interp_matrix_np(out_size, in_size)).to(
            device=device, dtype=dtype)
        _INTERP_CACHE[key] = m
    return m


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize (align_corners=False, half-pixel centers) of an HWC or
    NHWC tensor, as two separable matmuls with static interpolation
    matrices.  Integer input is resized in float32."""
    batched = img.dim() == 4
    x = img if batched else img[None]
    if x.shape[1] == out_h and x.shape[2] == out_w:
        return img
    dtype = x.dtype if x.is_floating_point() else torch.float32
    x = x.to(dtype)
    b, h, w, c = x.shape
    rh = _interp_matrix(out_h, h, dtype, x.device)
    rw = _interp_matrix(out_w, w, dtype, x.device)
    # channel planes (B*C, H, W) make both contractions plain row-major
    # products: (B*C*H, W) @ (W, P), then (O, H) @ (H, P) per plane
    planes = x.permute(0, 3, 1, 2).reshape(b * c, h, w)
    y = torch.matmul(rh, torch.matmul(planes, rw.T))          # (B*C, O, P)
    y = y.reshape(b, c, out_h, out_w).permute(0, 2, 3, 1).contiguous()
    return y if batched else y[0]


# BGR std of from-scratch training (torchvision's convention); converted
# detectron2-caffe checkpoints use std (1, 1, 1)
TRAIN_PIXEL_STD_BGR = (57.375, 57.12, 58.395)


def normalize_bgr(rgb: torch.Tensor,
                  pixel_mean: Tuple[float, ...] = (103.53, 116.28, 123.675),
                  pixel_std: Tuple[float, ...] = (1.0, 1.0, 1.0)
                  ) -> torch.Tensor:
    """RGB(I) (..., C>=3) uint8/float -> normalized BGR float32 (..., 3)
    (detectron2 caffe convention: BGR order, mean subtraction)."""
    # each of the three copies of host values to the card is a sync
    with span("sync.normalize"):
        bgr = rgb[..., [2, 1, 0]].to(torch.float32)
    with span("sync.normalize"):
        mean = torch.tensor(pixel_mean, dtype=torch.float32,
                            device=rgb.device)
    with span("sync.normalize"):
        std = torch.tensor(pixel_std, dtype=torch.float32, device=rgb.device)
    return (bgr - mean) / std


def ndvi_from_rgbi(rgbi: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """NDVI = (NIR - R) / (NIR + R + eps) in float32 from an RGBI tensor
    (..., 4): channel 0 red, channel 3 near infrared, both scaled by 1/255
    (the reference's numba kernel, ``helpers.py:862-896``)."""
    r = rgbi[..., 0].to(torch.float32) / 255.0
    nir = rgbi[..., 3].to(torch.float32) / 255.0
    return (nir - r) / (nir + r + eps)


def rescale_16bit(img: torch.Tensor) -> torch.Tensor:
    """16-bit -> 8-bit range rescale in float32 (reference
    ``prediction.py:167``)."""
    return img.to(torch.float32) / 257.0


def rgbi_to_model_input(rgbi: torch.Tensor, out_size: int,
                        pixel_mean: Tuple[float, ...] = (103.53, 116.28, 123.675),
                        pixel_std: Tuple[float, ...] = (1.0, 1.0, 1.0),
                        is_16bit: bool = False) -> torch.Tensor:
    """Tile -> model input: optional 16-bit rescale, BGR reorder, normalize,
    resize to the square model resolution.  HWC or NHWC in, the same out."""
    x = rgbi
    if is_16bit:
        x = rescale_16bit(x)
    x = normalize_bgr(x, pixel_mean, pixel_std)
    if x.shape[-3] != out_size or x.shape[-2] != out_size:
        x = resize_bilinear(x, out_size, out_size)
    return x
