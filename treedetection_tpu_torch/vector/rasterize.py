"""Scanline polygon rasterization (numpy, vectorized over rows).

Used for exact height/NDVI polygon statistics (fixing the bounding-circle
approximation of reference ``utilities.py:78-98``), fusion masks, and
rasterized polygon IoU.  Even–odd fill rule, pixel-center sampling (a pixel is
inside when its center is inside), matching rasterio.features.rasterize
defaults closely enough for threshold parity.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np

from treedetection_tpu_torch.geo.affine import Affine
from treedetection_tpu_torch.vector.polygon import ensure_open


def rasterize_polygon(coords: np.ndarray, transform: Affine,
                      out_shape: Tuple[int, int]) -> np.ndarray:
    """Rasterize one polygon ring -> bool mask of shape (H, W)."""
    h, w = out_shape
    mask = np.zeros((h, w), dtype=bool)
    _burn(mask, coords, transform, True)
    return mask


def rasterize_polygons(polys: Sequence[np.ndarray], transform: Affine,
                       out_shape: Tuple[int, int],
                       values: Iterable = None, dtype=np.int32) -> np.ndarray:
    """Burn many polygons into one raster; later polygons overwrite earlier."""
    h, w = out_shape
    out = np.zeros((h, w), dtype=dtype)
    vals = list(values) if values is not None else [1] * len(polys)
    for poly, v in zip(polys, vals):
        _burn(out, poly, transform, v)
    return out


def _burn(out: np.ndarray, coords: np.ndarray, transform: Affine, value) -> None:
    ring = ensure_open(coords)
    if len(ring) < 3:
        return
    inv = transform.invert()
    cols, rows = inv.apply(ring[:, 0], ring[:, 1])
    pts = np.stack([np.asarray(cols, dtype=np.float64),
                    np.asarray(rows, dtype=np.float64)], axis=1)

    h, w = out.shape[:2]
    r0 = max(0, int(np.floor(pts[:, 1].min())))
    r1 = min(h - 1, int(np.ceil(pts[:, 1].max())))
    if r1 < r0:
        return

    x1 = pts[:, 0]
    y1 = pts[:, 1]
    x2 = np.roll(x1, -1)
    y2 = np.roll(y1, -1)
    # Drop horizontal edges; they contribute no crossings.
    keep = y1 != y2
    x1, y1, x2, y2 = x1[keep], y1[keep], x2[keep], y2[keep]
    if len(x1) == 0:
        return

    ys = np.arange(r0, r1 + 1, dtype=np.float64) + 0.5  # pixel-center sampling
    # crossings[i, e]: edge e crosses scanline i
    Y = ys[:, None]
    cond = (np.minimum(y1, y2)[None, :] <= Y) & (Y < np.maximum(y1, y2)[None, :])
    with np.errstate(divide="ignore", invalid="ignore"):
        xint = x1[None, :] + (Y - y1[None, :]) * ((x2 - x1) / (y2 - y1))[None, :]
    xint = np.where(cond, xint, np.inf)
    xint.sort(axis=1)

    for i in range(xint.shape[0]):
        xs = xint[i]
        n = int(np.isfinite(xs).sum())
        row = r0 + i
        for k in range(0, n - 1, 2):
            # clamp BEFORE slicing: a span wholly left of the raster gives
            # b <= -2, and out[row, 0:b+1] with a negative stop would wrap
            # around and burn nearly the whole row
            a = max(int(np.ceil(xs[k] - 0.5)), 0)
            b = min(int(np.floor(xs[k + 1] - 0.5)), w - 1)
            if b >= a:
                out[row, a:b + 1] = value


def polygon_raster_stats(coords: np.ndarray, raster: np.ndarray,
                         transform: Affine) -> dict:
    """Stats of raster values inside one polygon: max/argmax/min/mean/var.

    The pipeline computes these in-batch on device (``ops.stats``); this is
    the host/oracle version used by tests and small files.  Returns argmax as
    geo (x, y) of the max pixel center, matching what the reference stores as
    the crown apex (reference ``postprocessing.py:25-115``).
    """
    h, w = raster.shape[:2]
    minx, miny, maxx, maxy = (float(coords[:, 0].min()), float(coords[:, 1].min()),
                              float(coords[:, 0].max()), float(coords[:, 1].max()))
    c0, r0, cw, ch = transform.window_for_bounds(minx, miny, maxx, maxy)
    c0, r0 = max(c0, 0), max(r0, 0)
    c1, r1 = min(c0 + cw + 1, w), min(r0 + ch + 1, h)
    if c1 <= c0 or r1 <= r0:
        return {"count": 0}
    sub = raster[r0:r1, c0:c1]
    subt = transform.window_transform(c0, r0)
    mask = rasterize_polygon(coords, subt, sub.shape[:2])
    vals = sub[mask]
    vals = vals[np.isfinite(vals)]
    if len(vals) == 0:
        return {"count": 0}
    # geo coords of max pixel; NaN nodata holes inside the polygon must not
    # win the argmax (np.argmax prefers NaN), so mask them out too
    masked = np.where(mask & np.isfinite(sub), sub, -np.inf)
    idx = np.unravel_index(int(np.argmax(masked)), masked.shape)
    gx, gy = subt.apply(idx[1] + 0.5, idx[0] + 0.5)
    return {
        "count": int(len(vals)),
        "max": float(vals.max()),
        "min": float(vals.min()),
        "mean": float(vals.mean()),
        "var": float(vals.var()),
        "argmax_xy": (float(gx), float(gy)),
    }
