"""Stage 3 — crown filtering: confidence, area, height, NDVI, dedupe,
containment, property enrichment.

Counterpart of ``treedetection_tpu/postprocessing.py`` with the same decision
rules and the same order of gates (reference ``postprocessing.py:722-809``;
gates at ``postprocessing.py:574-667``):

* polygon raster stats run batched on ``config["device"]`` (``ops.stats``)
  instead of a Python loop of per-polygon calls
* the stats use exact point-in-polygon sampling, fixing the reference's
  bounding-circle approximation (``utilities.py:78-98``); pass
  ``compat_circle=True`` for output parity with the reference
* the bbox IoU/area dedupe and the containment relation come as sparse pairs,
  by default from a uniform host grid; ``TD_PAIRS_DEVICE=1`` streams row
  blocks through the pairwise kernels (``ops.kernels.pairwise``: CUDA on the
  card, their plain versions on the CPU)

Device shapes are not padded to buckets (the JAX package pads for jit reuse);
results on the real rows are the same.

Output schema parity: ``processed_<name>.gpkg`` with Confidence_score,
poly_id, Area, TreeHeight, Centroid, Diameter, is_contained, num_contained
(reference ``postprocessing.py:904-919``).
"""

from __future__ import annotations

import json
import os
import re
import time as _time
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from treedetection_tpu_torch.config import select_device
from treedetection_tpu_torch.geo import Affine, GeoTiff
from treedetection_tpu_torch.ops.boxes import pairwise_intersection_over_area
from treedetection_tpu_torch.ops.kernels.pairwise import (
    pairwise_containment_mask, pairwise_dedupe_mask)
from treedetection_tpu_torch.ops.stats import (polygon_raster_stats_batch,
                                         polygon_raster_stats_batch_patch,
                                         polygon_raster_stats_two,
                                         polygon_raster_stats_two_patch)
from treedetection_tpu_torch.recoveries import (
    load_postprocess_recovery_data, postprocess_params,
    save_postprocess_recovery_data)
from treedetection_tpu_torch.vector import read_gpkg, simplify_polygon, write_gpkg
from treedetection_tpu_torch.vector.polygon import PolygonSet, ensure_open

AREA_UPPER_BOUND = 1000.0  # m^2; reference postprocessing.py:765-767

# Cumulative per-phase wall-clock over the process' postprocess calls, for
# perf triage; reset with .clear().
LAST_POSTPROCESS_STATS: Dict[str, float] = {}


# One entry per streamed-kernel relation call of the process: (kind, rows,
# row blocks launched).  Read beside the kernels' launch counts; reset with
# .clear().
PAIR_KERNEL_CALLS: List[Tuple[str, int, int]] = []


def _phase(name: str, t0: float) -> float:
    now = _time.time()
    LAST_POSTPROCESS_STATS[name] = \
        LAST_POSTPROCESS_STATS.get(name, 0.0) + (now - t0)
    return now


# --- dedupe ----------------------------------------------------------------

# Row-block size for streaming the pairwise relations: peak host memory is
# bounded at PAIRWISE_BLOCK x N uint8 regardless of N, so county-scale files
# (N ~ 10^5 crowns) never materialize the full N^2 matrix.
PAIRWISE_BLOCK = 8192


def _device(config: Dict[str, Any]) -> torch.device:
    """The device the stats and the pairwise kernels run on:
    ``config["device"]`` (default ``cuda``; CUDA without a card raises)."""
    return select_device(config.get("device", "cuda"))


def _grid_candidate_pairs(bounds: np.ndarray, cell: float
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Unordered candidate pairs (i < j) of boxes that share a uniform grid
    cell — the axis-aligned-crown replacement for an R-tree (SURVEY §2.3).

    Boxes are inserted into every cell they overlap; within a cell all pairs
    are candidates.  Crowns are bounded at ~35 m span (AREA_UPPER_BOUND), so
    per-box cell counts stay small and the pair set is ~linear in N.
    """
    n = len(bounds)
    if n < 2:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    gx0 = np.floor(bounds[:, 0] / cell).astype(np.int64)
    gy0 = np.floor(bounds[:, 1] / cell).astype(np.int64)
    gx1 = np.floor(bounds[:, 2] / cell).astype(np.int64)
    gy1 = np.floor(bounds[:, 3] / cell).astype(np.int64)
    nx = gx1 - gx0 + 1
    ny = gy1 - gy0 + 1
    stride = int(gy1.max() - gy0.min() + 2)
    base_y = gy0.min()
    cells_list = []
    idx_list = []
    for dx in range(int(nx.max())):
        for dy in range(int(ny.max())):
            sel = np.where((dx < nx) & (dy < ny))[0]
            if not len(sel):
                continue
            cells_list.append((gx0[sel] + dx) * stride
                              + (gy0[sel] + dy - base_y))
            idx_list.append(sel)
    cells = np.concatenate(cells_list)
    idx = np.concatenate(idx_list)
    order = np.argsort(cells, kind="stable")
    cells, idx = cells[order], idx[order]
    # group boundaries
    starts = np.flatnonzero(np.r_[True, cells[1:] != cells[:-1]])
    ends = np.r_[starts[1:], len(cells)]
    out_i = []
    out_j = []
    for s, e in zip(starts, ends):
        m = e - s
        if m < 2:
            continue
        members = idx[s:e]
        ii = np.repeat(members, m)
        jj = np.tile(members, m)
        keep = ii < jj
        out_i.append(ii[keep])
        out_j.append(jj[keep])
    if not out_i:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    pi = np.concatenate(out_i)
    pj = np.concatenate(out_j)
    # dedupe pairs seen in multiple shared cells
    key = pi * n + pj
    _, first = np.unique(key, return_index=True)
    return pi[first], pj[first]


def _sparse_relation_pairs(kind: str, bounds: np.ndarray, threshold: float,
                           areas: Optional[np.ndarray] = None,
                           area_threshold: float = 0.3,
                           block: int = PAIRWISE_BLOCK,
                           device: Optional[torch.device] = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse (i, j) index arrays of the pairwise relation, diagonal excluded.

    Default path: uniform-grid candidate generation on host + vectorized
    numpy criterion on the ~linear candidate set.  ``TD_PAIRS_DEVICE=1``
    forces the streamed kernel path on ``device`` (the CUDA kernels on the
    card, their plain versions on the CPU), which remains the oracle in tests
    and the right choice for extreme densities.
    """
    n = len(bounds)
    if n == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    if os.environ.get("TD_PAIRS_DEVICE") != "1":
        bounds = np.asarray(bounds, dtype=np.float64)
        # cell ~ median box size: small enough to keep groups tight, large
        # enough that typical boxes span few cells
        sizes = np.maximum(bounds[:, 2] - bounds[:, 0],
                           bounds[:, 3] - bounds[:, 1])
        cell = float(max(np.median(sizes) * 2.0, 1e-6))
        pi, pj = _grid_candidate_pairs(bounds, cell)
        if not len(pi):
            return pi, pj
        bi, bj = bounds[pi], bounds[pj]
        ix0 = np.maximum(bi[:, 0], bj[:, 0])
        iy0 = np.maximum(bi[:, 1], bj[:, 1])
        ix1 = np.minimum(bi[:, 2], bj[:, 2])
        iy1 = np.minimum(bi[:, 3], bj[:, 3])
        inter = np.maximum(ix1 - ix0, 0) * np.maximum(iy1 - iy0, 0)
        area_i = np.maximum(bi[:, 2] - bi[:, 0], 0) * \
            np.maximum(bi[:, 3] - bi[:, 1], 0)
        area_j = np.maximum(bj[:, 2] - bj[:, 0], 0) * \
            np.maximum(bj[:, 3] - bj[:, 1], 0)
        if kind == "dedupe":
            union = area_i + area_j - inter
            iou = np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)
            rel = iou > threshold
            if areas is not None:
                pa_i = np.asarray(areas, np.float64)[pi]
                pa_j = np.asarray(areas, np.float64)[pj]
                denom = np.maximum(np.maximum(pa_i, pa_j), 1e-12)
                rel &= (np.abs(pa_i - pa_j) / denom) < area_threshold
            sym_i = np.concatenate([pi[rel], pj[rel]])
            sym_j = np.concatenate([pj[rel], pi[rel]])
            return sym_i, sym_j
        # containment: (i contains j) = inter / area_j >= threshold,
        # evaluated in BOTH directions
        c_ij = np.where(area_j > 0, inter / np.maximum(area_j, 1e-12), 0.0) \
            >= threshold
        c_ji = np.where(area_i > 0, inter / np.maximum(area_i, 1e-12), 0.0) \
            >= threshold
        out_i = np.concatenate([pi[c_ij], pj[c_ji]])
        out_j = np.concatenate([pj[c_ij], pi[c_ji]])
        return out_i, out_j
    if device is None:
        raise ValueError("TD_PAIRS_DEVICE=1 needs the device to run on")
    out_i: List[np.ndarray] = []
    out_j: List[np.ndarray] = []
    b = torch.as_tensor(np.ascontiguousarray(bounds, dtype=np.float32)
                        ).to(device)
    a = (torch.as_tensor(np.ascontiguousarray(areas, dtype=np.float32)
                         ).to(device) if areas is not None else None)
    for s in range(0, n, block):
        e = min(s + block, n)
        if kind == "dedupe":
            m = pairwise_dedupe_mask(b, a, threshold, area_threshold,
                                     rows=b[s:e], row_areas=a[s:e])
        else:
            m = pairwise_containment_mask(b, threshold, rows=b[s:e])
        # fetch the relation BIT-PACKED: the dense block is rows x n bytes
        # and crosses the device->host link; 8x less traffic, unpacked by
        # numpy's C loop
        packed = _pack_bits_rows(m).cpu().numpy()
        bits = np.unpackbits(packed, axis=1, count=m.shape[1])
        ii, jj = np.nonzero(bits)
        ii = ii + s
        keep = ii != jj
        out_i.append(ii[keep])
        out_j.append(jj[keep])
    PAIR_KERNEL_CALLS.append((kind, n, len(out_i)))
    return np.concatenate(out_i), np.concatenate(out_j)


def _pack_bits_rows(m: torch.Tensor) -> torch.Tensor:
    """(R, N) 0/1 uint8 -> (R, ceil(N/8)) uint8, MSB-first (numpy
    ``unpackbits`` order); the last byte is zero-filled when N % 8 != 0."""
    r, nn = m.shape
    if nn % 8:
        m = torch.nn.functional.pad(m, (0, 8 - nn % 8))
    lanes = m.reshape(r, -1, 8)
    out = lanes[..., 0] << 7
    for k in range(1, 8):
        out = out | (lanes[..., k] << (7 - k))
    return out


def _areas_centroids_host(coords: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Shoelace areas + NaN-aware vertex centroids of NaN-padded rings
    (N, P, 2) — the host twin of ``ops.stats.polygon_areas_batch`` /
    ``polygon_centroids_batch`` (callers pad with at least one NaN row)."""
    c = coords.astype(np.float64)
    n, p = c.shape[0], c.shape[1]
    finite = np.isfinite(c[:, :, 0])
    lengths = finite.sum(axis=1)
    idx = np.clip(lengths, 0, p - 1)
    closed = c.copy()
    closed[np.arange(n), idx] = c[:, 0, :]
    x, y = closed[..., 0], closed[..., 1]
    xn = np.roll(x, -1, axis=1)
    yn = np.roll(y, -1, axis=1)
    term = x * yn - xn * y
    term = np.where(np.isfinite(term), term, 0.0)
    areas = np.abs(term.sum(axis=1)) / 2.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        centroids = np.stack([np.nanmean(c[..., 0], axis=1),
                              np.nanmean(c[..., 1], axis=1)], axis=-1)
    return areas.astype(np.float32), centroids


def _stats_patch_plan(spans_xy: np.ndarray, affine: Affine,
                      raster_shape: Tuple[int, int]
                      ) -> Tuple[int, np.ndarray]:
    """Pick the patch size for the patch-path stats op and flag which
    polygons fit it.  ``spans_xy``: (K, 2) local-frame bbox spans in meters.
    A patch that spans the whole raster axis serves ANY span on that axis
    (the window origin clamps to 0)."""
    h, w = raster_shape
    sx = spans_xy[:, 0] / max(abs(affine.a), 1e-9)
    sy = spans_xy[:, 1] / max(abs(affine.e), 1e-9)
    need = float(np.max(np.maximum(sx, sy))) + 4.0 if len(sx) else 8.0
    patch = 256
    for p in (32, 64, 128, 256):
        if p >= need:
            patch = p
            break
    patch = min(patch, max(h, 1), max(w, 1))
    fits = (((sx + 4.0 <= patch) | (patch >= w))
            & ((sy + 4.0 <= patch) | (patch >= h)))
    return patch, fits


def _host_polygon_raster_stats(poly: np.ndarray, raster: np.ndarray,
                               affine: Affine, grid: int = 32,
                               compat_circle: bool = False
                               ) -> Tuple[float, float, float,
                                          np.ndarray, float]:
    """numpy twin of ``ops.stats.polygon_raster_stats_batch`` for ONE open
    ring — serves the rare polygons whose pixel span outsizes every device
    patch (same grid, PIP, bilinear convention, and empty-count sentinels).
    -> (max, mean, var, argmax_xy, count)."""
    # f32 arithmetic THROUGHOUT, mirroring the device op — borderline
    # inside/outside decisions must agree between the paths
    p = poly[np.isfinite(poly[:, 0])].astype(np.float32)
    minxy, maxxy = p.min(axis=0), p.max(axis=0)
    span = np.maximum(maxxy - minxy, np.float32(1e-6))
    t = ((np.arange(grid, dtype=np.float32) + np.float32(0.5))
         / np.float32(grid))
    gx = minxy[0] + t * span[0]
    gy = minxy[1] + t * span[1]
    px = np.broadcast_to(gx[None, :], (grid, grid)).ravel()
    py = np.broadcast_to(gy[:, None], (grid, grid)).ravel()
    if compat_circle:
        center = (minxy + maxxy) / 2.0
        r2 = np.max(((p - center) ** 2).sum(axis=1))
        inside = ((px - center[0]) ** 2 + (py - center[1]) ** 2) <= r2
    else:
        x1, y1 = p[:, 0], p[:, 1]
        x2 = np.roll(x1, -1)
        y2 = np.roll(y1, -1)
        cond = (y1[None, :] > py[:, None]) != (y2[None, :] > py[:, None])
        with np.errstate(all="ignore"):
            xint = x1[None, :] + (py[:, None] - y1[None, :]) \
                * ((x2 - x1) / (y2 - y1))[None, :]
            cross = np.sum(cond & (px[:, None] < xint), axis=1)
        inside = (cross % 2) == 1
    a, c, e, f = (np.float32(affine.a), np.float32(affine.c),
                  np.float32(affine.e), np.float32(affine.f))
    ci = (px - c) / a - np.float32(0.5)
    ri = (py - f) / e - np.float32(0.5)
    h, w = raster.shape
    in_r = (ci >= -0.5) & (ci <= w - 0.5) & (ri >= -0.5) & (ri <= h - 0.5)
    c0 = np.clip(np.floor(ci).astype(np.int64), 0, w - 1)
    r0 = np.clip(np.floor(ri).astype(np.int64), 0, h - 1)
    c1 = np.minimum(c0 + 1, w - 1)
    r1 = np.minimum(r0 + 1, h - 1)
    lc = np.clip(ci - c0, 0.0, 1.0)
    lr = np.clip(ri - r0, 0.0, 1.0)
    v = (raster[r0, c0] * (1 - lr) * (1 - lc)
         + raster[r0, c1] * (1 - lr) * lc
         + raster[r1, c0] * lr * (1 - lc) + raster[r1, c1] * lr * lc)
    v = np.where(in_r, v, np.nan)
    ok = inside & np.isfinite(v)
    count = int(ok.sum())
    if count == 0:
        return -1.0, -1.0, -1.0, np.array([px[0], py[0]]), 0.0
    vals = v[ok]
    mean = float(vals.mean())
    var = float(((vals - mean) ** 2).mean())
    neg = np.where(ok, v, -np.inf)
    am = int(np.argmax(neg))
    return float(vals.max()), mean, var, np.array([px[am], py[am]]), count


def _ragged_ring_stats(rings: List[np.ndarray]
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Shoelace areas, vertex centroids, and bboxes of OPEN rings, computed
    ragged (``np.*.reduceat`` over the concatenated points).

    Same math as ``_areas_centroids_host`` + ``PolygonSet.bounds`` but far
    cheaper at county crown counts: the padded (N, 128, 2) route streams
    many full passes over mostly-NaN padding, the ragged route touches each
    real vertex once.  Centroid = plain vertex mean (reference
    ``utilities.py:163-180``; the padded host path also mixed in the closing
    vertex once — the device twin ``polygon_centroids_batch`` never did).
    """
    n = len(rings)
    lens = np.fromiter((len(r) for r in rings), np.int64, n)
    starts = np.zeros(n, np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    flat = np.concatenate(rings, axis=0).astype(np.float64)
    x, y = flat[:, 0], flat[:, 1]
    nx = np.empty_like(x)
    ny = np.empty_like(y)
    nx[:-1] = x[1:]
    ny[:-1] = y[1:]
    ends = starts + lens - 1
    nx[ends] = x[starts]
    ny[ends] = y[starts]
    term = x * ny - nx * y
    areas = np.abs(np.add.reduceat(term, starts)) / 2.0
    cx = np.add.reduceat(x, starts) / lens
    cy = np.add.reduceat(y, starts) / lens
    bounds = np.stack([np.minimum.reduceat(x, starts),
                       np.minimum.reduceat(y, starts),
                       np.maximum.reduceat(x, starts),
                       np.maximum.reduceat(y, starts)], axis=1)
    return (areas.astype(np.float32), np.stack([cx, cy], axis=1),
            bounds.astype(np.float32))


def _greedy_group_keep(pairs_i: np.ndarray, pairs_j: np.ndarray,
                       scores: np.ndarray, n: int) -> np.ndarray:
    """Greedy group-keep over a sparse relation: visiting rows in index order,
    each not-yet-removed row's group (neighbors + itself) keeps only its
    highest-confidence member (exact reference loop semantics,
    ``postprocessing.py:384-400``).  Rows without neighbors never remove
    anything, so only connected rows are visited — O(E) host work."""
    remove = np.zeros(n, dtype=bool)
    if len(pairs_i) == 0:
        return ~remove
    order = np.argsort(pairs_i, kind="stable")
    pi, pj = pairs_i[order], pairs_j[order]
    starts = np.searchsorted(pi, np.arange(n + 1))
    for i in np.unique(pi):
        if remove[i]:
            continue
        connected = np.append(pj[starts[i]:starts[i + 1]], i)
        best = connected[np.argmax(scores[connected])]
        remove[connected[connected != best]] = True
    return ~remove


def filter_by_iou_and_area(bounds: np.ndarray, areas: np.ndarray,
                           scores: np.ndarray, iou_threshold: float,
                           area_threshold: float = 0.3,
                           device: Optional[torch.device] = None
                           ) -> np.ndarray:
    """Greedy group-dedupe keep-mask (reference ``postprocessing.py:349-406``):
    polygons whose bbox IoU exceeds the threshold AND whose relative area
    difference is below ``area_threshold`` form a group; only the
    highest-confidence member survives.  The relation comes as sparse pairs
    (``_sparse_relation_pairs``); greedy scan over them on host."""
    n = len(bounds)
    if n == 0:
        return np.zeros(0, dtype=bool)
    pairs_i, pairs_j = _sparse_relation_pairs(
        "dedupe", bounds, iou_threshold, areas=areas,
        area_threshold=area_threshold, device=device)
    return _greedy_group_keep(pairs_i, pairs_j, scores, n)


# --- containment -------------------------------------------------------------

def containment_matrix(bounds: np.ndarray, threshold: float
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (is_contained_in_someone (N,), num_contained (N,), max_ratio (N,)).

    ``contains[i, j]`` = intersection(bbox_i, bbox_j) / area(bbox_j) >= t,
    diagonal off; ``num_contained[i]`` counts how many others i contains
    (reference ``process_containment_features``, ``postprocessing.py:408-476``).
    """
    n = len(bounds)
    if n == 0:
        z = np.zeros(0)
        return z.astype(bool), z.astype(int), z
    b = torch.as_tensor(np.asarray(bounds, dtype=np.float32))
    ratios = pairwise_intersection_over_area(b, b).T.numpy()  # [i,j]: inter/area_j
    contains = ratios >= threshold
    np.fill_diagonal(contains, False)
    num_contained = contains.sum(axis=1)
    is_contained = contains.any(axis=0)
    max_ratio = ratios.max(axis=0)
    return is_contained, num_contained, max_ratio


def apply_containment_rules_sparse(pairs_i: np.ndarray, pairs_j: np.ndarray,
                                   mean_ndvi: np.ndarray, var_ndvi: np.ndarray,
                                   areas: np.ndarray, n: int) -> np.ndarray:
    """Containment case analysis over the sparse contains relation -> keep
    mask.  Fully vectorized (each row's decision is independent).

    Decision rules (reference ``postprocessing.py:636-667``; its literal code
    mixes indices, so this is the documented intent):
    * contains >= 3 others: cluster blob, drop
    * contains exactly 2: drop when mutually contained in one of them
    * contains exactly 1: keep the better of the pair — lower NDVI variance
      when mean NDVI differs by > 0.05, else larger area
    * contains 0: keep
    """
    keep = np.ones(n, dtype=bool)
    if len(pairs_i) == 0:
        return keep
    nc = np.bincount(pairs_i, minlength=n)
    keep[nc >= 3] = False
    # mutual containment per pair: (j, i) also present
    codes = pairs_i.astype(np.int64) * n + pairs_j
    rev = pairs_j.astype(np.int64) * n + pairs_i
    mutual = np.isin(rev, codes)
    mutual_rows = np.bincount(pairs_i, weights=mutual, minlength=n) > 0
    keep[(nc == 2) & mutual_rows] = False
    # single-containment tie-break: the one contained row j per i (first by
    # index, matching np.where(...)[0][0] in the dense loop)
    one = nc == 1
    if one.any():
        order = np.argsort(pairs_i, kind="stable")
        pi, pj = pairs_i[order], pairs_j[order]
        starts = np.searchsorted(pi, np.arange(n))
        i1 = np.where(one)[0]
        j1 = pj[starts[i1]]
        d_ndvi = np.abs(mean_ndvi[i1] - mean_ndvi[j1])
        drop = np.where(d_ndvi > 0.05,
                        var_ndvi[i1] >= var_ndvi[j1],
                        areas[i1] <= areas[j1])
        keep[i1[drop]] = False
    return keep


def apply_containment_rules(num_contained: np.ndarray, is_contained: np.ndarray,
                            mean_ndvi: np.ndarray, var_ndvi: np.ndarray,
                            areas: np.ndarray, contains: Optional[np.ndarray] = None,
                            bounds: Optional[np.ndarray] = None,
                            threshold: float = 0.9) -> np.ndarray:
    """Dense-matrix wrapper around :func:`apply_containment_rules_sparse`
    (kept for API compatibility; ``num_contained``/``is_contained`` are
    recomputed from the relation)."""
    n = len(num_contained)
    if contains is None:
        if bounds is None:
            raise ValueError("need contains matrix or bounds")
        b = torch.as_tensor(np.asarray(bounds, dtype=np.float32))
        ratios = pairwise_intersection_over_area(b, b).T.numpy()
        contains = ratios >= threshold
        np.fill_diagonal(contains, False)
    pairs_i, pairs_j = np.nonzero(contains)
    return apply_containment_rules_sparse(pairs_i, pairs_j, mean_ndvi,
                                          var_ndvi, areas, n)


# --- border / overlap-strip exclusion ---------------------------------------

def border_overlap_exclusion(bounds: np.ndarray,
                             raster_bounds: Tuple[float, float, float, float],
                             config: Dict[str, Any],
                             is_merged_strip: bool,
                             eps: float = 1.0) -> np.ndarray:
    """Keep-mask dropping crowns near the raster border and, for non-strip
    images, crowns entirely inside the overlap-interior band that the merged
    strips re-predict (reference ``postprocessing.py:574-607``)."""
    n = len(bounds)
    keep = np.ones(n, dtype=bool)
    if n == 0 or not config.get("use_overlap", True):
        return keep
    left, bottom, right, top = raster_bounds
    near_border = ((bounds[:, 0] - left < eps) | (right - bounds[:, 2] < eps) |
                   (bounds[:, 1] - bottom < eps) | (top - bounds[:, 3] < eps))
    keep &= ~near_border
    if not is_merged_strip:
        half_w = ((config["tile_width"] + 2 * config["buffer"])
                  * config["overlapping_tiles_width"]) / 2.0
        half_h = ((config["tile_height"] + 2 * config["buffer"])
                  * config["overlapping_tiles_height"]) / 2.0
        inside_left = bounds[:, 2] < left + half_w
        inside_right = bounds[:, 0] > right - half_w
        inside_bottom = bounds[:, 3] < bottom + half_h
        inside_top = bounds[:, 1] > top - half_h
        keep &= ~(inside_left | inside_right | inside_bottom | inside_top)
    return keep


# --- main per-file pipeline ---------------------------------------------------

def process_crowns(crowns: List[np.ndarray], scores: np.ndarray,
                   config: Dict[str, Any],
                   height_raster: Optional[np.ndarray],
                   height_affine: Optional[Affine],
                   ndvi_raster: Optional[np.ndarray],
                   ndvi_affine: Optional[Affine],
                   raster_bounds: Optional[Tuple[float, float, float, float]],
                   is_merged_strip: bool = False,
                   compat_circle: bool = False
                   ) -> Tuple[List[np.ndarray], List[Dict[str, Any]]]:
    """Full crown-filter pipeline on already-loaded data; returns
    (kept geometries, property dicts)."""
    if not crowns:
        return [], []
    device = _device(config)
    _t = _time.time()

    scores = np.asarray(scores, dtype=np.float32)
    conf = float(config.get("confidence_threshold", 0.3))
    keep0 = scores >= conf
    crowns = [c for c, k in zip(crowns, keep0) if k]
    scores = scores[keep0]
    if not crowns:
        return [], []

    # simplify tolerance 2 m (reference postprocessing.py:746-754)
    crowns = [simplify_polygon(c, 2.0) for c in crowns]
    crowns = [ensure_open(c) for c in crowns]
    nonempty = [len(c) >= 3 for c in crowns]
    crowns = [c for c, k in zip(crowns, nonempty) if k]
    scores = scores[np.asarray(nonempty, dtype=bool)]
    if not crowns:
        return [], []
    _t = _phase("simplify", _t)

    # Device math runs in float32, where UTM-magnitude coordinates (~5e6 m
    # northing) have an ulp of 0.5 m — shoelace/stat cancellation at that
    # magnitude produces garbage.  Shift everything into a per-file LOCAL
    # frame first (areas/IoU/stats are translation-invariant); the raster
    # affines and bounds shift by the same offset below.
    offset = np.floor(np.min(np.asarray(
        [c.min(axis=0) for c in crowns], dtype=np.float64), axis=0))
    local = [c - offset for c in crowns]
    n_all = len(crowns)
    # areas/centroids/bboxes are trivial FLOP on ~20k rings: ragged host
    # numpy touches each vertex once (the padded device coords are built
    # LATER, for the post-dedupe stats survivors only)
    areas, centroids, bounds = _ragged_ring_stats(local)
    centroids = centroids + offset[None, :]
    _t = _phase("areas_centroids", _t)

    area_lo = float(config.get("area_threshold", 1))
    keep = (areas >= area_lo) & (areas <= AREA_UPPER_BOUND)

    # bbox IoU/area dedupe
    keep_idx = np.where(keep)[0]
    if len(keep_idx):
        dk = filter_by_iou_and_area(
            bounds[keep_idx], areas[keep_idx], scores[keep_idx],
            float(config.get("iou_threshold", 0.5)), device=device)
        keep[keep_idx[~dk]] = False
    _t = _phase("iou_dedupe", _t)

    # raster stats only on the post-dedupe survivors (the reference also
    # computes stats after dedupe, ``process_features``)
    heights = np.full(n_all, -1.0, dtype=np.float32)
    argmax_xy = np.zeros((n_all, 2), dtype=np.float32)
    mean_ndvi = np.full(n_all, -1.0, dtype=np.float32)
    var_ndvi = np.full(n_all, -1.0, dtype=np.float32)

    def _local_affine(t: Affine) -> Affine:
        # same local frame as the polygons (float32-safe magnitudes)
        return Affine(t.a, t.b, t.c - offset[0], t.d, t.e, t.f - offset[1])

    # border/overlap exclusion BEFORE the raster stats: it is independent of
    # them (bbox-only test), and on an overlap run it drops every crown in
    # the border band, which would otherwise be PIP-sampled for stats and
    # then thrown away.  Same final keep mask
    # and properties (all gates are ANDed; reference applies it at
    # postprocessing.py:574-607 after stats, but no gate reads the other's
    # output).
    if raster_bounds is not None:
        rb_local = (raster_bounds[0] - offset[0], raster_bounds[1] - offset[1],
                    raster_bounds[2] - offset[0], raster_bounds[3] - offset[1])
        keep &= border_overlap_exclusion(bounds, rb_local, config,
                                         is_merged_strip)
    _t = _phase("border_exclusion", _t)

    sub = np.where(keep)[0]
    if len(sub) and (height_raster is not None or ndvi_raster is not None):
        # Routing: the PATCH-path stats op (per-polygon raster windows + hat
        # -matrix contractions) for axis-aligned affines and polygons whose
        # pixel span fits the chosen window; it replaces the gather-path op's
        # 4-tap scattered reads.  Over-span polygons (rare giants) go through
        # the exact numpy twin; non-axis-aligned affines keep the gather op.
        la_h = (_local_affine(height_affine)
                if height_raster is not None else None)
        la_n = (_local_affine(ndvi_affine)
                if ndvi_raster is not None else None)
        aligned = all(t is None or (t.b == 0.0 and t.d == 0.0)
                      for t in (la_h, la_n))
        use_patch = aligned and os.environ.get("TD_STATS_PATCH", "1") != "0"
        spans_xy = np.stack([bounds[sub, 2] - bounds[sub, 0],
                             bounds[sub, 3] - bounds[sub, 1]], axis=1)
        patch_h = patch_n = 64
        fits = np.ones(len(sub), bool)
        if use_patch:
            if height_raster is not None:
                patch_h, fh = _stats_patch_plan(spans_xy, la_h,
                                                height_raster.shape)
                fits &= fh
            if ndvi_raster is not None:
                patch_n, fn = _stats_patch_plan(spans_xy, la_n,
                                                ndvi_raster.shape)
                fits &= fn
            dev = sub[fits]
            host_out = sub[~fits]
        else:
            dev, host_out = sub, sub[:0]
        if len(dev):
            dev_coords = PolygonSet.from_list(
                [local[i] for i in dev], dtype=np.float32).coords
            _tu = _time.time()

            def _up(arr, dtype=np.float32):
                return torch.as_tensor(
                    np.ascontiguousarray(arr, dtype=dtype)).to(device)

            sub_t = _up(dev_coords)
            hr_t = _up(height_raster) if height_raster is not None else None
            nr_t = _up(ndvi_raster) if ndvi_raster is not None else None
            ah_t = _up(list(la_h)) if la_h is not None else None
            an_t = _up(list(la_n)) if la_n is not None else None
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            _phase("stats_upload", _tu)
            _tc = _time.time()
            st_h = st_n = None
            if hr_t is not None and nr_t is not None:
                # fused two-raster call: sample grid + PIP shared
                # (reference fused path postprocessing.py:549-554,
                # generalized to distinct grids)
                if use_patch:
                    st_h, st_n = polygon_raster_stats_two_patch(
                        sub_t, hr_t, ah_t, nr_t, an_t, patch_a=patch_h,
                        patch_b=patch_n, compat_circle=compat_circle)
                else:
                    st_h, st_n = polygon_raster_stats_two(
                        sub_t, hr_t, ah_t, nr_t, an_t,
                        compat_circle=compat_circle)
                phase = "stats_fused_call"
            elif hr_t is not None:
                if use_patch:
                    st_h = polygon_raster_stats_batch_patch(
                        sub_t, hr_t, ah_t, patch=patch_h,
                        compat_circle=compat_circle)
                else:
                    st_h = polygon_raster_stats_batch(
                        sub_t, hr_t, ah_t, compat_circle=compat_circle)
                phase = "stats_height_call"
            else:
                if use_patch:
                    st_n = polygon_raster_stats_batch_patch(
                        sub_t, nr_t, an_t, patch=patch_n,
                        compat_circle=compat_circle)
                else:
                    st_n = polygon_raster_stats_batch(
                        sub_t, nr_t, an_t, compat_circle=compat_circle)
                phase = "stats_ndvi_call"
            if st_h is not None:
                heights[dev] = st_h.max.cpu().numpy()
                argmax_xy[dev] = st_h.argmax_xy.cpu().numpy() \
                    + offset[None, :]
            if st_n is not None:
                mean_ndvi[dev] = st_n.mean.cpu().numpy()
                var_ndvi[dev] = st_n.var.cpu().numpy()
            _phase(phase, _tc)
        for i in host_out:
            if height_raster is not None:
                h_mx, _, _, am, cnt = _host_polygon_raster_stats(
                    local[i], height_raster, la_h,
                    compat_circle=compat_circle)
                heights[i] = h_mx
                if cnt:
                    argmax_xy[i] = am + offset
            if ndvi_raster is not None:
                _, n_mean, n_var, _, _ = _host_polygon_raster_stats(
                    local[i], ndvi_raster, la_n,
                    compat_circle=compat_circle)
                mean_ndvi[i] = n_mean
                var_ndvi[i] = n_var
    _t = _phase("raster_stats", _t)

    # height gate (-1 = no data passes; reference postprocessing.py:609-610)
    h_thr = float(config.get("height_threshold", 3))
    keep &= ~((heights < h_thr) & (heights > -1.0))
    # NDVI gates (reference postprocessing.py:612-613)
    m_thr = float(config.get("ndvi_mean_threshold", 0.1))
    v_thr = float(config.get("ndvi_var_threshold", 0.1))
    keep &= ~(((mean_ndvi < m_thr) | (var_ndvi > v_thr)) & (mean_ndvi > -1.0))

    # containment on the survivors: sparse relation (host grid or streamed
    # kernel blocks), rules fully vectorized
    idx = np.where(keep)[0]
    if len(idx) == 0:
        return [], []
    c_thr = float(config.get("containment_threshold", 0.9))
    m = len(idx)
    pairs_i, pairs_j = _sparse_relation_pairs("containment", bounds[idx],
                                              c_thr, device=device)
    num_contained = np.bincount(pairs_i, minlength=m)
    is_contained = np.zeros(m, dtype=bool)
    is_contained[pairs_j] = True
    ckeep = apply_containment_rules_sparse(
        pairs_i, pairs_j, mean_ndvi[idx], var_ndvi[idx], areas[idx], m)
    final_idx = idx[ckeep]
    _t = _phase("containment", _t)

    out_geoms: List[np.ndarray] = []
    out_props: List[Dict[str, Any]] = []
    sub = {int(g): p for p, g in enumerate(idx)}
    for i in final_idx:
        j = sub[int(i)]
        out_geoms.append(np.round(crowns[i], 6))
        out_props.append({
            "Confidence_score": float(scores[i]),
            "poly_id": int(i),
            "Area": float(areas[i]),
            "TreeHeight": float(heights[i]),
            "Centroid": f"{{'x': {float(centroids[i, 0])}, 'y': {float(centroids[i, 1])}}}",
            "Diameter": float(2.0 * np.sqrt(max(areas[i], 0) / np.pi)),
            "is_contained": bool(is_contained[j]),
            "num_contained": int(num_contained[j]),
        })
    return out_geoms, out_props


def load_rasters_for_file(height_path: Optional[str], rgbi_path: Optional[str],
                          config: Dict[str, Any]
                          ) -> Tuple[Optional[np.ndarray], Optional[Affine],
                                     Optional[np.ndarray], Optional[Affine],
                                     Optional[Tuple[float, float, float, float]]]:
    """Read the nDSM (scaled by height_scaling_factor) and the RGBI -> NDVI
    raster (scaled by ndvi_scaling_factor) with rescaled transforms (reference
    ``postprocessing.py:780-800``).

    Both rasters are read ALREADY DECIMATED via strip-chunked windowed reads
    (``GeoTiff.read_scaled``) — matching the reference's scaled ``out_shape``
    reads — and NDVI is computed on the decimated pixels (reference order:
    downsample, then ``ndvi_array_from_rgbi``).  A county-scale RGBI never
    materializes as a full-resolution float array, and the NDVI math stays on
    host.
    """
    height_raster = height_affine = None
    ndvi_raster = ndvi_affine = None
    raster_bounds = None
    hs = float(config.get("height_scaling_factor", 1.0))
    ns = float(config.get("ndvi_scaling_factor", 0.2))
    if height_path and os.path.exists(height_path):
        g = GeoTiff(height_path)
        if hs != 1.0:
            nh = max(int(round(g.height * hs)), 1)
            nw = max(int(round(g.width * hs)), 1)
            arr, height_affine = g.read_scaled(nh, nw, nodata_to_nan=True)
            arr = arr[:, :, 0]
        else:
            arr = g.read()[:, :, 0].astype(np.float32)
            if g.nodata is not None:
                arr = np.where(arr == g.nodata, np.nan, arr)
            height_affine = g.transform
        height_raster = arr
        raster_bounds = g.bounds
        g.close()
    if rgbi_path and os.path.exists(rgbi_path):
        g = GeoTiff(rgbi_path)
        if g.count >= 4:
            nh = max(int(round(g.height * ns)), 1)
            nw = max(int(round(g.width * ns)), 1)
            if ns != 1.0:
                rgbi, ndvi_affine = g.read_scaled(nh, nw)
            else:
                rgbi, ndvi_affine = g.read().astype(np.float32), g.transform
            r = rgbi[:, :, 0] / 255.0
            nir = rgbi[:, :, 3] / 255.0
            ndvi_raster = (nir - r) / (nir + r + 1e-7)
        raster_bounds = raster_bounds or g.bounds
        g.close()
    return height_raster, height_affine, ndvi_raster, ndvi_affine, raster_bounds


def _downscale(arr: np.ndarray, transform: Affine, factor: float,
               device=None) -> Tuple[np.ndarray, Affine]:
    """Resample by ``factor`` (<1 shrinks) with bilinear sampling and a
    correspondingly rescaled transform, on ``device`` (default: the card)."""
    from treedetection_tpu_torch.ops.image import resize_bilinear
    h, w = arr.shape[:2]
    nh, nw = max(int(round(h * factor)), 1), max(int(round(w * factor)), 1)
    x = torch.as_tensor(np.ascontiguousarray(arr)).to(select_device(device))
    out = resize_bilinear(x[..., None], nh, nw)[..., 0].cpu().numpy()
    new_t = Affine(transform.a * w / nw, transform.b, transform.c,
                   transform.d, transform.e * h / nh, transform.f)
    return out, new_t


# --- directory loop ----------------------------------------------------------

def find_matching_file(stem: str, index: Dict[str, str], regexes: Sequence[str]
                       ) -> Optional[str]:
    """Match a stitched layer to its raster by concatenated regex groups
    (reference ``postprocessing.py:995-1017``)."""
    for rx in regexes:
        m = re.match(rx, stem + ".tif")
        if m:
            key = "".join(m.groups())
            if key in index:
                return index[key]
    return None


def build_file_index(paths: Sequence[str], regexes: Sequence[str]) -> Dict[str, str]:
    index: Dict[str, str] = {}
    for p in paths:
        name = os.path.basename(p)
        for rx in regexes:
            m = re.match(rx, name)
            if m:
                index["".join(m.groups())] = p
                break
    return index


def _load_band_sidecar_bounds(gpkg_path: str
                              ) -> Optional[Tuple[float, float, float, float]]:
    """Bounds recorded by prediction's band pre-drop (``band_predrop.json``
    in the per-tile prediction dir — ``<pred_root>/<stem>/`` single-model,
    ``<pred_root>/{urban,forest}/<stem>/`` two-model)."""
    stem = Path(gpkg_path).stem
    root = os.path.dirname(gpkg_path)
    for sub in (stem, os.path.join("urban", stem),
                os.path.join("forest", stem)):
        sc = os.path.join(root, sub, "band_predrop.json")
        if os.path.exists(sc):
            try:
                with open(sc) as fh:
                    b = json.load(fh)["bounds"]
                return (float(b[0]), float(b[1]), float(b[2]), float(b[3]))
            except (OSError, ValueError, KeyError, IndexError):
                return None
    return None


def process_single_file(gpkg_path: str, config: Dict[str, Any],
                        height_path: Optional[str], rgbi_path: Optional[str],
                        out_path: str, is_merged_strip: bool = False) -> int:
    """Filter one stitched GPKG -> processed GPKG; returns crown count
    (reference ``process_single_file``, ``postprocessing.py:876-943``)."""
    _tr = _time.time()
    geoms, props, srs = read_gpkg(gpkg_path)
    _phase("gpkg_read", _tr)
    crowns = []
    scores = []
    for g, p in zip(geoms, props):
        if not g or not g[0]:
            continue
        crowns.append(np.asarray(g[0][0], dtype=np.float64))
        scores.append(float(p.get("Confidence_score", 0.0)))
    _t0 = _time.time()
    hr, ha, nr, na, rb = load_rasters_for_file(height_path, rgbi_path, config)
    if rb is None:
        # No raster matched -> border_overlap_exclusion would not run; but
        # if prediction's band PRE-DROP ran for this layer it already
        # deleted certain-discard crowns, so the exclusion MUST still run
        # with the same bounds.  The predictor records them in a
        # ``band_predrop.json`` sidecar next to the per-tile predictions.
        rb = _load_band_sidecar_bounds(gpkg_path)
    _phase("raster_load", _t0)
    out_geoms, out_props = process_crowns(
        crowns, np.asarray(scores, dtype=np.float32), config,
        hr, ha, nr, na, rb, is_merged_strip=is_merged_strip)
    _tw = _time.time()
    write_gpkg(out_path, out_geoms, out_props, srs_id=srs)
    _phase("gpkg_write", _tw)
    return len(out_geoms)


def process_files_in_directory(config: Dict[str, Any], gpkg_dir: str,
                               image_paths: Sequence[str],
                               height_paths: Sequence[str],
                               out_dir: Optional[str] = None) -> List[str]:
    """Pair each stitched ``.gpkg`` with its RGBI + nDSM rasters and filter it
    (reference ``process_files_in_directory``, ``postprocessing.py:945-1076``)."""
    logger = config.get("logger")
    out_dir = out_dir or gpkg_dir
    os.makedirs(out_dir, exist_ok=True)
    params = postprocess_params(config)
    done = set(load_postprocess_recovery_data(out_dir, params))
    completed = list(done)

    img_rx = [config.get("image_regex", r"(\d+)\.tif")]
    h_rx = [config.get("height_data_regex", r"(\d+)\.tif")]
    img_merged_rx = config.get("image_merged_regex")
    h_merged_rx = config.get("height_data_merged_regex")
    if img_merged_rx:
        img_rx.append(img_merged_rx)
    if h_merged_rx:
        h_rx.append(h_merged_rx)
    img_index = build_file_index(image_paths, img_rx)
    h_index = build_file_index(height_paths, h_rx)

    outputs: List[str] = []
    gpkgs = sorted(p for p in os.listdir(gpkg_dir)
                   if p.endswith(".gpkg") and not p.startswith("processed_"))
    todo: List[Tuple[str, str, Optional[str], Optional[str], bool]] = []
    for name in gpkgs:
        stem = Path(name).stem
        out_path = os.path.join(out_dir, f"processed_{name}")
        outputs.append(out_path)
        if name in done and os.path.exists(out_path):
            continue
        rgbi = find_matching_file(stem, img_index, img_rx)
        height = find_matching_file(stem, h_index, h_rx)
        merged = bool(img_merged_rx and re.match(img_merged_rx, stem + ".tif"))
        if height is None and logger:
            logger.warning(f"No height raster matched for {name}")
        todo.append((name, out_path, height, rgbi, merged))

    # file-level thread pool (reference used a 5-thread pool,
    # ``postprocessing.py:1051``): raster decode + vector I/O parallelize,
    # the device work of the workers queues on the card; the recovery manifest
    # is saved from the main thread as completions land.
    from concurrent.futures import ThreadPoolExecutor, as_completed
    workers = max(min(int(config.get("num_workers") or 5), len(todo) or 1), 1)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        futs = {ex.submit(process_single_file, os.path.join(gpkg_dir, name),
                          config, height, rgbi, out_path,
                          is_merged_strip=merged): name
                for name, out_path, height, rgbi, merged in todo}
        for i, fut in enumerate(as_completed(futs)):
            name = futs[fut]
            try:
                n = fut.result()
                if logger:
                    logger.info(f"Postprocessed {name}: {n} crowns "
                                f"({i + 1}/{len(todo)})")
            except (OSError, ValueError) as exc:  # keep batch alive (ref :941-943)
                if logger:
                    logger.error(f"Postprocessing failed for {name}: {exc}")
                continue
            completed.append(name)
            save_postprocess_recovery_data(out_dir, params, completed)
    return outputs
