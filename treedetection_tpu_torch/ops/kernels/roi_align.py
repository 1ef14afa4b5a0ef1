"""K1 — the flat ROIAlign patch pooler: CUDA kernel, wrapper, plain version.

Replaces ``roi_pool_patches_flat`` (``treedetection_tpu/ops/pallas/
roi_align_kernel.py``) with the same contract::

    roi_pool_patches_flat(fcat, rows, cols, ay, ax, resolution, patch=48)
        -> out (N, R, R, C),  out[i] = ay[i] . fcat[rows[i]:+patch,
                                                    cols[i]:+patch+8, :] . ax[i]^T

``fcat`` (rows_total, W, C) float32 or bfloat16, contiguous; ``rows`` and
``cols`` (N,) int32 window origins with ``cols % 8 == 0``; ``ay`` (N, R,
patch) and ``ax`` (N, R, patch+8) float32 hat matrices.

The CUDA source is ``csrc/roi_pool_flat.cu`` (what bounds it and its design
are noted there).  It is compiled with nvcc for ``sm_90a`` at first use into
the package's build directory and bound with ctypes.  For a CUDA tensor the
wrapper launches the kernel or raises; only a tensor that lies on the CPU
takes :func:`roi_pool_patches_flat_reference`, the plain PyTorch version
the tests and ``chip_smoke.py`` hold the kernel against.

Rounding: the kernel and the plain version keep the hat matrices and the
intermediate ``A_y . window`` in float32 and round only the output to the
feature dtype.  (The TPU kernel also rounds the hats and the intermediate
to bf16 in production.)
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import torch

from treedetection_tpu_torch.build import build_shared_library, nvcc_path

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "roi_pool_flat.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
RESOLUTIONS = (7, 14)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (a plain count; chip_smoke.py reads
# it to show the main path went through the kernel)
launches = 0

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def build() -> Path:
    """Compile (or find) the kernel library; returns its path.  The
    compiler's output (``-Xptxas -v`` register/shared-memory report) is kept
    beside it as ``<name>.log``."""
    return build_shared_library("roi_pool_flat", [_SRC],
                                [nvcc_path()] + NVCC_FLAGS)


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build()))
                fn = lib.td_roi_pool_flat
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
                    ctypes.c_void_p]
                _lib = lib
    return _lib


def _check(fcat, rows, cols, ay, ax, resolution: int, patch: int) -> None:
    if fcat.dtype not in _DTYPE_CODE:
        raise TypeError(f"fcat must be float32 or bfloat16, got {fcat.dtype}")
    if fcat.dim() != 3:
        raise ValueError(f"fcat must be (rows, W, C), got {tuple(fcat.shape)}")
    n = rows.shape[0]
    shapes = {"rows": (rows, (n,), torch.int32),
              "cols": (cols, (n,), torch.int32),
              "ay": (ay, (n, resolution, patch), torch.float32),
              "ax": (ax, (n, resolution, patch + 8), torch.float32)}
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("fcat", fcat), ("rows", rows), ("cols", cols),
                    ("ay", ay), ("ax", ax)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != fcat.device:
            raise ValueError(f"{name} is on {t.device}, fcat on {fcat.device}")
    if fcat.shape[0] < patch or fcat.shape[1] < patch + 8:
        raise ValueError(f"fcat {tuple(fcat.shape)} is smaller than one "
                         f"({patch}, {patch + 8}) window")
    if n and bool((cols % 8 != 0).any()):
        raise ValueError("cols must be multiples of 8")


def roi_pool_patches_flat(fcat: torch.Tensor, rows: torch.Tensor,
                          cols: torch.Tensor, ay: torch.Tensor,
                          ax: torch.Tensor, resolution: int,
                          patch: int = 48) -> torch.Tensor:
    """Pool N boxes -> (N, R, R, C) from one level-concatenated buffer."""
    global launches
    _check(fcat, rows, cols, ay, ax, resolution, patch)
    if fcat.device.type == "cpu":
        return roi_pool_patches_flat_reference(fcat, rows, cols, ay, ax,
                                               resolution, patch)
    if fcat.device.type != "cuda":
        raise ValueError(f"unsupported device {fcat.device}")
    if resolution not in RESOLUTIONS:
        raise ValueError(f"the kernel is built for resolutions {RESOLUTIONS}, "
                         f"got {resolution}")
    n, c = rows.shape[0], fcat.shape[-1]
    out = torch.empty((n, resolution, resolution, c), dtype=fcat.dtype,
                      device=fcat.device)
    lib = _get_lib()
    with torch.cuda.device(fcat.device):
        stream = torch.cuda.current_stream(fcat.device).cuda_stream
        rc = lib.td_roi_pool_flat(
            fcat.data_ptr(), rows.data_ptr(), cols.data_ptr(), ay.data_ptr(),
            ax.data_ptr(), out.data_ptr(), n, resolution, patch,
            fcat.shape[0], fcat.shape[1], c, _DTYPE_CODE[fcat.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"td_roi_pool_flat failed with CUDA error {rc}")
    launches += 1
    return out


def roi_pool_patches_flat_reference(fcat: torch.Tensor, rows: torch.Tensor,
                                    cols: torch.Tensor, ay: torch.Tensor,
                                    ax: torch.Tensor, resolution: int,
                                    patch: int = 48,
                                    chunk: int = 64) -> torch.Tensor:
    """Plain PyTorch version: gather each box's window, then two einsums in
    float32, chunked over boxes (all windows at once would not fit)."""
    n, c = rows.shape[0], fcat.shape[-1]
    out = torch.empty((n, resolution, resolution, c), dtype=fcat.dtype,
                      device=fcat.device)
    ar_y = torch.arange(patch, device=fcat.device)
    ar_x = torch.arange(patch + 8, device=fcat.device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        ry = rows[s:e].long()[:, None] + ar_y                 # (k, patch)
        cx = cols[s:e].long()[:, None] + ar_x                 # (k, patch+8)
        win = fcat[ry[:, :, None], cx[:, None, :]].float()    # (k, P, P+8, C)
        t = torch.einsum("kiy,kyxc->kixc", ay[s:e].float(), win)
        out[s:e] = torch.einsum("kjx,kixc->kijc", ax[s:e].float(),
                                t).to(fcat.dtype)
    return out
