"""Native (C++) host helpers, loaded via ctypes.

* ``td_trace_contours`` — Suzuki-Abe border following + CHAIN_APPROX_SIMPLE
  compression (the mask -> polygon step of the Predictor)
* ``td_resize_threshold`` — fused bilinear resize + threshold of a soft mask
* ``td_lzw_decode`` — TIFF LZW fast path for the GeoTIFF codec
* ``td_simplify_dp`` — Douglas-Peucker keep flags for crown rings

The library (``LIBRARY``) is compiled from ``contour.cpp`` with g++ at first
use into the package's build directory and loaded there
(``treedetection_tpu_torch.build``).  There is no fallback: a failed build
raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Optional

import numpy as np

from treedetection_tpu_torch.build import Library, load

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)

LIBRARY = Library(
    "td_native", (Path(__file__).resolve().parent / "contour.cpp",), {
        "td_trace_contours": [_U8P, ctypes.c_int, ctypes.c_int, _I32P, _I32P,
                              _U8P, ctypes.c_int, ctypes.c_int],
        "td_resize_threshold": [_U8P, ctypes.c_int, ctypes.c_int, _U8P,
                                ctypes.c_int, ctypes.c_int, ctypes.c_float],
        "td_lzw_decode": [_U8P, ctypes.c_long, _U8P, ctypes.c_long],
        "td_simplify_dp": [ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                           ctypes.c_double, _U8P]},
    flags=("-O3", "-shared", "-fPIC", "-std=c++17"), compiler="g++")


def trace_contours(mask: np.ndarray, include_holes: bool = True
                   ) -> List[np.ndarray]:
    """Binary mask (H, W) -> list of (N, 2) integer (x, y) boundary rings."""
    mask = np.ascontiguousarray(mask.astype(np.uint8))
    h, w = mask.shape
    lib = load(LIBRARY)
    # border following visits a boundary pixel at most 4 times, so 4*h*w
    # bounds the total points; contour-count overflow retries with a larger
    # budget instead of silently truncating
    max_pts = 4 * h * w + 1024
    max_ctr = 4096
    out_xy = np.empty(2 * max_pts, dtype=np.int32)
    while True:
        out_sizes = np.empty(max_ctr, dtype=np.int32)
        out_hole = np.empty(max_ctr, dtype=np.uint8)
        n = lib.td_trace_contours(
            mask.ctypes.data_as(_U8P), h, w, out_xy.ctypes.data_as(_I32P),
            out_sizes.ctypes.data_as(_I32P), out_hole.ctypes.data_as(_U8P),
            max_pts, max_ctr)
        if n < max_ctr or max_ctr >= h * w:
            break
        max_ctr *= 4
    contours = []
    off = 0
    for i in range(n):
        k = out_sizes[i]
        if include_holes or not out_hole[i]:
            contours.append(out_xy[2 * off: 2 * (off + k)].reshape(k, 2).copy())
        off += k
    return contours


def resize_threshold_mask(mask: np.ndarray, out_h: int, out_w: int,
                          thresh: float = 127.5) -> np.ndarray:
    """Soft uint8 mask -> bilinear resize (half-pixel centers) -> 0/1 mask."""
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    out = np.empty((out_h, out_w), dtype=np.uint8)
    load(LIBRARY).td_resize_threshold(
        mask.ctypes.data_as(_U8P), mask.shape[0], mask.shape[1],
        out.ctypes.data_as(_U8P), out_h, out_w, ctypes.c_float(thresh))
    return out


def lzw_decode(data: bytes, expected: int) -> Optional[bytes]:
    """Native TIFF LZW decode; None when the decoder rejects the stream."""
    src = np.frombuffer(data, dtype=np.uint8)
    dst = np.empty(expected, dtype=np.uint8)
    rc = load(LIBRARY).td_lzw_decode(
        src.ctypes.data_as(_U8P), len(data), dst.ctypes.data_as(_U8P),
        expected)
    if rc < 0:
        return None
    return dst[:rc].tobytes()


def simplify_keep_flags(ring: np.ndarray, tolerance: float) -> np.ndarray:
    """Douglas-Peucker keep flags for an OPEN (N, 2) float64 ring: the same
    keep set as the numpy stack version in ``vector.polygon``."""
    ring = np.ascontiguousarray(ring, dtype=np.float64)
    n = len(ring)
    keep = np.empty(n, dtype=np.uint8)
    load(LIBRARY).td_simplify_dp(
        ring.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        ctypes.c_double(tolerance * tolerance), keep.ctypes.data_as(_U8P))
    return keep.view(bool)
