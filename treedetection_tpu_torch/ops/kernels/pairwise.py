"""K2, K3, K4 — the pairwise box-relation masks: CUDA kernel, wrappers, plain
versions.

Replaces ``pairwise_dedupe_mask`` (K2), ``pairwise_containment_mask`` (K3) and
``pairwise_iou_mask`` (K4) of ``treedetection_tpu/ops/pallas/iou_kernel.py``
with the same contracts.  For row boxes ``rows`` (R, 4) (default: ``boxes``,
the square case) and column boxes ``boxes`` (N, 4), float32 ``[x0, y0, x1,
y1]``, each returns an (R, N) uint8 mask:

* :func:`pairwise_iou_mask` — ``IoU(row_i, box_j) > threshold`` (0 where the
  union is 0);
* :func:`pairwise_containment_mask` — ``inter(row_i, box_j) / area(box_j) >=
  threshold`` (0 where the area is 0); in the square case the diagonal is
  cleared;
* :func:`pairwise_dedupe_mask` — ``IoU > iou_threshold`` AND ``|pa_i - pa_j| /
  max(pa_i, pa_j, 1e-9) < area_threshold`` on the polygon areas.

The CUDA source is ``csrc/pairwise_boxes.cu``: one kernel template over the
three modes, compiled with nvcc for ``sm_90a`` at first use and bound with
ctypes.  Rounding decides a threshold test, so the source is built with
``-fmad=false`` and keeps the plain versions' order of operations; the masks
are then equal bit for bit, which is what ``chip_smoke.py`` and the card
tests check.  For a CUDA tensor a wrapper launches the kernel or raises; only
tensors on the CPU take the plain versions (``*_reference``).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

from treedetection_tpu_torch.build import build_shared_library, nvcc_path
from treedetection_tpu_torch.ops.boxes import (
    box_iou_matrix, pairwise_intersection_over_area)

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "pairwise_boxes.cu"
# -fmad=false: no FMA contraction, so every operation rounds as the plain
# version's separate elementwise operations do (never -use_fast_math)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_MODE = {"iou": 0, "containment": 1, "dedupe": 2}

# kernel launches since the last reset, per wrapper (plain counts;
# chip_smoke.py reads them to show the main path went through the kernel)
launches: Dict[str, int] = {"iou": 0, "containment": 0, "dedupe": 0}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def build() -> Path:
    """Compile (or find) the kernel library; returns its path.  The
    compiler's output (``-Xptxas -v``) is kept beside it as ``<name>.log``."""
    return build_shared_library("pairwise_boxes", [_SRC],
                                [nvcc_path()] + NVCC_FLAGS)


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build()))
                fn = lib.td_pairwise_boxes
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
                    ctypes.c_float] * 2 + [ctypes.c_void_p]
                _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, width: int,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != 2 or t.shape[1] != width:
        raise ValueError(f"{name} must be (n, {width}), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _launch(mode: str, a: torch.Tensor, b: torch.Tensor, t0: float,
            t1: float) -> torch.Tensor:
    """(R, N) uint8 relation of a's rows against b's rows on the card."""
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.uint8,
                      device=a.device)
    if out.numel() == 0:
        return out
    lib = _get_lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.td_pairwise_boxes(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0],
            b.shape[0], _MODE[mode], float(t0), float(t1), stream)
    if rc != 0:
        raise RuntimeError(f"td_pairwise_boxes({mode}) failed with CUDA "
                           f"error {rc}")
    launches[mode] += 1
    return out


def _f32(value: float, device: torch.device) -> torch.Tensor:
    """A threshold as a float32 scalar: the comparison is made in float32,
    as the kernel makes it."""
    return torch.tensor(float(value), dtype=torch.float32, device=device)


# --- plain versions ----------------------------------------------------------

def iou_mask_reference(a: torch.Tensor, b: torch.Tensor,
                       threshold: float) -> torch.Tensor:
    return (box_iou_matrix(a, b) > _f32(threshold, a.device)).to(torch.uint8)


def containment_mask_reference(a: torch.Tensor, b: torch.Tensor,
                               threshold: float) -> torch.Tensor:
    """contains[i, j] = inter(a_i, b_j) / area(b_j) >= threshold (no
    diagonal rule)."""
    # ratios[j, i] = inter / area_j -> transpose for contains[i, j]
    ratio = pairwise_intersection_over_area(b, a).T
    return (ratio >= _f32(threshold, a.device)).to(torch.uint8)


def dedupe_mask_reference(a5: torch.Tensor, b5: torch.Tensor,
                          iou_threshold: float,
                          area_threshold: float) -> torch.Tensor:
    iou = box_iou_matrix(a5[:, :4], b5[:, :4])
    pa = a5[:, 4][:, None]
    pb = b5[:, 4][None, :]
    rel = (pa - pb).abs() / torch.clamp(torch.maximum(pa, pb), min=1e-9)
    return ((iou > _f32(iou_threshold, a5.device))
            & (rel < _f32(area_threshold, a5.device))).to(torch.uint8)


# --- wrappers ----------------------------------------------------------------

def pairwise_iou_mask(boxes: torch.Tensor, threshold: float,
                      rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(R, N) uint8 mask of IoU(row_i, box_j) > threshold; ``rows`` defaults
    to ``boxes`` (the square case)."""
    a = boxes if rows is None else rows
    _check("boxes", boxes, 4, boxes.device)
    _check("rows", a, 4, boxes.device)
    if boxes.device.type == "cpu":
        return iou_mask_reference(a, boxes, threshold)
    return _launch("iou", a, boxes, threshold, 0.0)


def pairwise_containment_mask(boxes: torch.Tensor, threshold: float,
                              rows: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """(R, N) uint8: row_i contains box_j (intersection/area_j >= threshold);
    for the square case the diagonal is cleared."""
    a = boxes if rows is None else rows
    _check("boxes", boxes, 4, boxes.device)
    _check("rows", a, 4, boxes.device)
    if boxes.device.type == "cpu":
        out = containment_mask_reference(a, boxes, threshold)
    else:
        out = _launch("containment", a, boxes, threshold, 0.0)
    if rows is None:
        out.fill_diagonal_(0)
    return out


def pairwise_dedupe_mask(boxes: torch.Tensor, areas: torch.Tensor,
                         iou_threshold: float, area_threshold: float = 0.3,
                         rows: Optional[torch.Tensor] = None,
                         row_areas: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """(R, N) uint8 dedupe relation: bbox IoU > iou_threshold AND relative
    polygon-area difference < area_threshold."""
    _check("boxes", boxes, 4, boxes.device)
    _check("areas", areas.reshape(-1, 1) if areas.dim() == 1 else areas, 1,
           boxes.device)
    if areas.shape[0] != boxes.shape[0]:
        raise ValueError(f"{boxes.shape[0]} boxes but {areas.shape[0]} areas")
    b5 = torch.cat([boxes, areas.reshape(-1, 1)], dim=1)
    if rows is None:
        a5 = b5
    else:
        if row_areas is None:
            raise ValueError("rows given without row_areas")
        _check("rows", rows, 4, boxes.device)
        _check("row_areas", row_areas.reshape(-1, 1)
               if row_areas.dim() == 1 else row_areas, 1, boxes.device)
        if row_areas.shape[0] != rows.shape[0]:
            raise ValueError(
                f"{rows.shape[0]} rows but {row_areas.shape[0]} row_areas")
        a5 = torch.cat([rows, row_areas.reshape(-1, 1)], dim=1)
    if boxes.device.type == "cpu":
        return dedupe_mask_reference(a5, b5, iou_threshold, area_threshold)
    return _launch("dedupe", a5, b5, iou_threshold, area_threshold)
