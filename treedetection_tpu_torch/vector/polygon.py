"""Vectorized numpy polygon operations.

These are the host-side geometry primitives that replace shapely/GEOS in the
reference's hot paths (simplify at ``helpers.py:463-464``, box filtering at
``helpers.py:466-468``, within/intersects joins at ``helpers.py:364,806-812``,
IoU at ``utilities.py:209-212``).  A polygon is an (N, 2) float64 array of
exterior-ring coordinates (holes are not produced by the crown pipeline and are
dropped on ingest, matching the reference's contour handling which only keeps
exterior rings, ``prediction.py:232-246``).

The batched, padded forms for the device path live in
``treedetection_tpu_torch.ops.stats``; this module stays numpy so the vector
I/O layer has no torch dependency.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

Coords = np.ndarray  # (N, 2)


def ensure_closed(coords: Coords) -> Coords:
    """Return ring with first point == last point."""
    coords = np.asarray(coords, dtype=np.float64)
    if len(coords) == 0:
        return coords.reshape(0, 2)
    # scalar first/last compare: this runs per crown in the stitch/postprocess
    # hot loops, where np.array_equal's dispatch overhead dominated the
    # native simplify call itself (profiled 2x the DP kernel)
    f, l = coords[0], coords[-1]
    if f[0] != l[0] or f[1] != l[1]:
        out = np.empty((len(coords) + 1, 2), dtype=np.float64)
        out[:-1] = coords
        out[-1] = f
        return out
    return coords


def ensure_open(coords: Coords) -> Coords:
    """Return ring without the duplicated closing point."""
    coords = np.asarray(coords, dtype=np.float64)
    if len(coords) > 1:
        f, l = coords[0], coords[-1]
        if f[0] == l[0] and f[1] == l[1]:
            return coords[:-1]
    return coords


def polygon_area(coords: Coords) -> float:
    """Unsigned shoelace area."""
    c = ensure_open(coords)
    if len(c) < 3:
        return 0.0
    x, y = c[:, 0], c[:, 1]
    return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) / 2.0)


def signed_area(coords: Coords) -> float:
    c = ensure_open(coords)
    if len(c) < 3:
        return 0.0
    x, y = c[:, 0], c[:, 1]
    return float((np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) / 2.0)


def polygon_centroid(coords: Coords) -> Tuple[float, float]:
    """Area-weighted centroid (falls back to vertex mean for degenerate rings)."""
    c = ensure_open(coords)
    if len(c) < 3:
        m = c.mean(axis=0) if len(c) else np.zeros(2)
        return float(m[0]), float(m[1])
    x, y = c[:, 0], c[:, 1]
    xn, yn = np.roll(x, -1), np.roll(y, -1)
    cross = x * yn - xn * y
    a = cross.sum() / 2.0
    if abs(a) < 1e-12:
        m = c.mean(axis=0)
        return float(m[0]), float(m[1])
    cx = ((x + xn) * cross).sum() / (6.0 * a)
    cy = ((y + yn) * cross).sum() / (6.0 * a)
    return float(cx), float(cy)


def polygon_bounds(coords: Coords) -> Tuple[float, float, float, float]:
    c = np.asarray(coords, dtype=np.float64)
    return (float(c[:, 0].min()), float(c[:, 1].min()),
            float(c[:, 0].max()), float(c[:, 1].max()))


def polygons_bounds(polys: Sequence[Coords]) -> np.ndarray:
    """(N, 4) array of per-polygon (minx, miny, maxx, maxy)."""
    out = np.empty((len(polys), 4), dtype=np.float64)
    for i, p in enumerate(polys):
        out[i] = polygon_bounds(p)
    return out


def simplify_polygon(coords: Coords, tolerance: float) -> Coords:
    """Douglas–Peucker ring simplification (shapely ``simplify`` semantics as
    used for crown smoothing at reference ``helpers.py:463-464``).

    Returns a closed ring.  The keep flags come from the native helper
    (``native.simplify_keep_flags``); :func:`simplify_polygon_numpy` is the
    plain version the tests hold it against.
    """
    c = ensure_open(coords)
    if len(c) < 4 or tolerance <= 0:
        return ensure_closed(c)
    from treedetection_tpu_torch import native
    out = c[native.simplify_keep_flags(c, tolerance)]
    if len(out) < 3:
        return ensure_closed(c)
    return ensure_closed(out)


def simplify_polygon_numpy(coords: Coords, tolerance: float) -> Coords:
    """Plain numpy Douglas–Peucker (iterative stack): the same keep set as
    :func:`simplify_polygon`."""
    c = ensure_open(coords)
    n = len(c)
    if n < 4 or tolerance <= 0:
        return ensure_closed(c)
    # Anchor the ring at index 0 and its farthest vertex so DP sees two chains.
    d2 = ((c - c[0]) ** 2).sum(axis=1)
    pivot = int(np.argmax(d2))
    if pivot == 0:
        return ensure_closed(c)
    keep = np.zeros(n, dtype=bool)
    keep[0] = keep[pivot] = True
    tol2 = tolerance * tolerance

    stack = [(0, pivot), (pivot, n)]  # second chain wraps to 0 via index n
    pts = np.vstack([c, c[:1]])
    while stack:
        i, j = stack.pop()
        if j - i < 2:
            continue
        seg = pts[i:j + 1]
        a, b = seg[0], seg[-1]
        ab = b - a
        denom = (ab * ab).sum()
        rel = seg[1:-1] - a
        if denom < 1e-18:
            dist2 = (rel * rel).sum(axis=1)
        else:
            t = np.clip((rel @ ab) / denom, 0.0, 1.0)
            proj = np.outer(t, ab)
            diff = rel - proj
            dist2 = (diff * diff).sum(axis=1)
        if len(dist2) == 0:
            continue
        k = int(np.argmax(dist2))
        if dist2[k] > tol2:
            mid = i + 1 + k
            keep[mid % n] = True
            stack.append((i, mid))
            stack.append((mid, j))
    out = c[keep]
    if len(out) < 3:
        return ensure_closed(c)
    return ensure_closed(out)


def points_in_polygon(points: np.ndarray, coords: Coords) -> np.ndarray:
    """Vectorized even–odd point-in-polygon test.

    ``points``: (M, 2); returns (M,) bool.  Replaces the bounding-circle
    *approximation* the reference used on GPU (``utilities.py:78-98``) with an
    exact test (a compat circle test lives in ``ops.geometry`` behind a flag).
    """
    pts = np.asarray(points, dtype=np.float64)
    c = ensure_open(coords)
    n = len(c)
    if n < 3:
        return np.zeros(len(pts), dtype=bool)
    x, y = pts[:, 0][:, None], pts[:, 1][:, None]
    x1, y1 = c[:, 0][None, :], c[:, 1][None, :]
    x2, y2 = np.roll(c[:, 0], -1)[None, :], np.roll(c[:, 1], -1)[None, :]
    cond = (y1 > y) != (y2 > y)
    with np.errstate(divide="ignore", invalid="ignore"):
        xint = x1 + (y - y1) * (x2 - x1) / (y2 - y1)
    crossings = (cond & (x < xint)).sum(axis=1)
    return (crossings % 2).astype(bool)


def clip_polygon_box(coords: Coords, box: Tuple[float, float, float, float]) -> Coords:
    """Sutherland–Hodgman clip of a ring against an axis-aligned box.

    Used for clipping crowns/outlines to tile or file bounds (reference clips
    with geopandas at ``helpers.py:735-739``).  Returns a closed ring (possibly
    empty).
    """
    minx, miny, maxx, maxy = box
    poly = ensure_open(coords)

    def clip_edge(pts: np.ndarray, inside_fn, intersect_fn) -> np.ndarray:
        if len(pts) == 0:
            return pts
        nxt = np.roll(pts, -1, axis=0)
        out: List[np.ndarray] = []
        ins_cur = inside_fn(pts)
        ins_nxt = inside_fn(nxt)
        for i in range(len(pts)):
            cur, nx = pts[i], nxt[i]
            if ins_cur[i]:
                out.append(cur)
                if not ins_nxt[i]:
                    out.append(intersect_fn(cur, nx))
            elif ins_nxt[i]:
                out.append(intersect_fn(cur, nx))
        return np.array(out) if out else np.zeros((0, 2))

    def ix(v):  # intersection with vertical line x=v
        def f(p, q):
            t = (v - p[0]) / (q[0] - p[0])
            return np.array([v, p[1] + t * (q[1] - p[1])])
        return f

    def iy(v):
        def f(p, q):
            t = (v - p[1]) / (q[1] - p[1])
            return np.array([p[0] + t * (q[0] - p[0]), v])
        return f

    poly = clip_edge(poly, lambda p: p[:, 0] >= minx, ix(minx))
    poly = clip_edge(poly, lambda p: p[:, 0] <= maxx, ix(maxx))
    poly = clip_edge(poly, lambda p: p[:, 1] >= miny, iy(miny))
    poly = clip_edge(poly, lambda p: p[:, 1] <= maxy, iy(maxy))
    return ensure_closed(poly)


def _segments_intersect(p: Coords, q: Coords) -> bool:
    """Any-pair segment intersection between two rings (vectorized orientation test)."""
    a1 = ensure_open(p)
    b1 = ensure_open(q)
    if len(a1) < 2 or len(b1) < 2:
        return False
    a2 = np.roll(a1, -1, axis=0)
    b2 = np.roll(b1, -1, axis=0)

    # orientation(o, a, b) for all combinations: (Na, Nb)
    def cross(o, a, b):
        return ((a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1])
                - (a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0]))

    A1 = a1[:, None, :]
    A2 = a2[:, None, :]
    B1 = b1[None, :, :]
    B2 = b2[None, :, :]
    d1 = cross(A1, A2, B1)
    d2 = cross(A1, A2, B2)
    d3 = cross(B1, B2, A1)
    d4 = cross(B1, B2, A2)
    proper = (np.sign(d1) * np.sign(d2) < 0) & (np.sign(d3) * np.sign(d4) < 0)
    return bool(proper.any())


def _segments_touch(p: Coords, q: Coords) -> bool:
    """Any boundary CONTACT between two rings: an endpoint of one segment
    lying on the other (covers T-contacts and collinear shared edges, which
    the proper-crossing test in :func:`_segments_intersect` misses —
    shapely's ``intersects`` counts these as True)."""
    a1 = ensure_open(p)
    b1 = ensure_open(q)
    if len(a1) < 2 or len(b1) < 2:
        return False
    a2 = np.roll(a1, -1, axis=0)
    b2 = np.roll(b1, -1, axis=0)

    def on_segment(s1, s2, pt):
        cr = ((s2[..., 0] - s1[..., 0]) * (pt[..., 1] - s1[..., 1])
              - (s2[..., 1] - s1[..., 1]) * (pt[..., 0] - s1[..., 0]))
        inside = ((pt[..., 0] >= np.minimum(s1[..., 0], s2[..., 0]))
                  & (pt[..., 0] <= np.maximum(s1[..., 0], s2[..., 0]))
                  & (pt[..., 1] >= np.minimum(s1[..., 1], s2[..., 1]))
                  & (pt[..., 1] <= np.maximum(s1[..., 1], s2[..., 1])))
        return (cr == 0) & inside

    A1, A2 = a1[:, None, :], a2[:, None, :]
    B1, B2 = b1[None, :, :], b2[None, :, :]
    return bool((on_segment(A1, A2, B1) | on_segment(A1, A2, B2)
                 | on_segment(B1, B2, A1) | on_segment(B1, B2, A2)).any())


def polygon_intersects(p: Coords, q: Coords) -> bool:
    """True if the two polygons share any area or boundary point."""
    pb, qb = polygon_bounds(p), polygon_bounds(q)
    if pb[0] > qb[2] or qb[0] > pb[2] or pb[1] > qb[3] or qb[1] > pb[3]:
        return False
    if _segments_intersect(p, q):
        return True
    if bool(points_in_polygon(ensure_open(p)[:1], q)[0]
            or points_in_polygon(ensure_open(q)[:1], p)[0]):
        return True
    # boundary-only contact (shared edge / T-touch): shapely intersects()
    # semantics count it (reference helpers.py:364,806-812)
    return _segments_touch(p, q)


def polygon_within(p: Coords, q: Coords) -> bool:
    """True if polygon ``p`` lies entirely within polygon ``q``."""
    po = ensure_open(p)
    if len(po) == 0:
        return False
    if not points_in_polygon(po, q).all():
        return False
    return not _segments_intersect(p, q)


def _clip_convex_by_halfplane(pts: List[Tuple[float, float]],
                              a: Tuple[float, float], b: Tuple[float, float]
                              ) -> List[Tuple[float, float]]:
    """Sutherland-Hodgman step: keep the part of convex ``pts`` left of a->b."""
    out: List[Tuple[float, float]] = []
    n = len(pts)
    ex, ey = b[0] - a[0], b[1] - a[1]
    for i in range(n):
        cx, cy = pts[i]
        px, py = pts[i - 1]
        c_in = ex * (cy - a[1]) - ey * (cx - a[0]) >= 0
        p_in = ex * (py - a[1]) - ey * (px - a[0]) >= 0
        if c_in != p_in:
            dx, dy = cx - px, cy - py
            denom = ex * dy - ey * dx
            if denom != 0:
                # f(p) = ex*(py-ay) - ey*(px-ax); crossing at t = -f(p)/denom
                t = (ey * (px - a[0]) - ex * (py - a[1])) / denom
                out.append((px + t * dx, py + t * dy))
        if c_in:
            out.append((cx, cy))
    return out


def _tri_intersection_area(t1, t2) -> float:
    """Area of the intersection of two CCW triangles (exact convex clip)."""
    pts = list(t2)
    for i in range(3):
        pts = _clip_convex_by_halfplane(pts, t1[i], t1[(i + 1) % 3])
        if len(pts) < 3:
            return 0.0
    a = 0.0
    for i in range(len(pts)):
        x0, y0 = pts[i - 1]
        x1, y1 = pts[i]
        a += x0 * y1 - x1 * y0
    return a / 2.0


def polygon_intersection_area(p: Coords, q: Coords) -> float:
    """EXACT area of intersection of two simple polygons.

    Signed fan-triangle decomposition: the winding-number function of a
    simple polygon equals the signed sum of its fan triangles' indicators,
    so ``area(P∩Q) = sum_ij s_i s_j area(T_i ∩ T_j)`` with each term an
    exact convex-convex clip.  O(|P|·|Q|) pairs — meant for eval/parity
    instrumentation (the 0.99-IoU gate), not hot loops; the rasterized
    :func:`polygon_iou` stays the fast path.
    """
    p = ensure_open(np.asarray(p, dtype=np.float64))
    q = ensure_open(np.asarray(q, dtype=np.float64))
    if len(p) < 3 or len(q) < 3:
        return 0.0
    pb, qb = polygon_bounds(p), polygon_bounds(q)
    if pb[0] >= qb[2] or qb[0] >= pb[2] or pb[1] >= qb[3] or qb[1] >= pb[3]:
        return 0.0

    def fan(poly):
        tris = []
        x0, y0 = poly[0]
        for i in range(1, len(poly) - 1):
            x1, y1 = poly[i]
            x2, y2 = poly[i + 1]
            s = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
            if s == 0:
                continue
            t = ((x0, y0), (x1, y1), (x2, y2))
            if s < 0:  # orient CCW for the clipper; keep the sign
                t = (t[0], t[2], t[1])
            tris.append((1.0 if s > 0 else -1.0, t))
        return tris

    total = 0.0
    for s1, t1 in fan(p):
        for s2, t2 in fan(q):
            total += s1 * s2 * _tri_intersection_area(t1, t2)
    return abs(total)


def polygon_iou_exact(p: Coords, q: Coords) -> float:
    """Exact polygon IoU (see :func:`polygon_intersection_area`)."""
    inter = polygon_intersection_area(p, q)
    if inter <= 0.0:
        return 0.0
    union = polygon_area(p) + polygon_area(q) - inter
    return inter / union if union > 0 else 0.0


def polygon_iou(p: Coords, q: Coords, resolution: Optional[float] = None) -> float:
    """Polygon IoU via adaptive-resolution rasterization.

    Exact GEOS intersections are replaced with a rasterized estimate whose grid
    is ~512 cells across the union bbox (sub-centimeter at crown scale); used by
    dedupe/eval paths (reference ``utilities.py:209-212``,
    ``evaluation_compute_scores.py:55-111``).
    """
    pb, qb = polygon_bounds(p), polygon_bounds(q)
    minx, miny = min(pb[0], qb[0]), min(pb[1], qb[1])
    maxx, maxy = max(pb[2], qb[2]), max(pb[3], qb[3])
    if maxx <= minx or maxy <= miny:
        return 0.0
    if pb[0] > qb[2] or qb[0] > pb[2] or pb[1] > qb[3] or qb[1] > pb[3]:
        return 0.0
    if resolution is None:
        resolution = max(maxx - minx, maxy - miny) / 512.0
    from treedetection_tpu_torch.vector.rasterize import rasterize_polygon
    from treedetection_tpu_torch.geo.affine import Affine

    w = max(2, int(np.ceil((maxx - minx) / resolution)))
    h = max(2, int(np.ceil((maxy - miny) / resolution)))
    tr = Affine.from_origin(minx, maxy, (maxx - minx) / w, (maxy - miny) / h)
    mp = rasterize_polygon(p, tr, (h, w))
    mq = rasterize_polygon(q, tr, (h, w))
    inter = np.logical_and(mp, mq).sum()
    union = np.logical_or(mp, mq).sum()
    return float(inter) / float(union) if union else 0.0


class PolygonSet:
    """A batch of polygons as a padded (N, P, 2) array + per-polygon lengths.

    The bridge between list-of-rings (host I/O) and fixed-shape arrays the
    device stats consume (replacing the reference's NaN-padded CuPy
    arrays, ``postprocessing.py:509-540``).
    """

    def __init__(self, coords: np.ndarray, lengths: np.ndarray):
        self.coords = coords      # (N, P, 2) float32/64, padded with NaN
        self.lengths = lengths    # (N,) int32

    @classmethod
    def from_list(cls, polys: Sequence[Coords], max_points: Optional[int] = None,
                  dtype=np.float64) -> "PolygonSet":
        rings = [ensure_open(p) for p in polys]
        lens = np.array([len(r) for r in rings], dtype=np.int32)
        # +1: every ring keeps at least one NaN pad row — the device kernels'
        # _close_rings writes the closing vertex into the first pad slot, and
        # a ring with zero padding would get its LAST REAL vertex overwritten
        P = int(max_points or (lens.max() + 1 if len(lens) else 1))
        out = np.full((len(rings), max(P, 1), 2), np.nan, dtype=dtype)
        for i, r in enumerate(rings):
            k = min(len(r), P)
            out[i, :k] = r[:k]
        return cls(out, np.minimum(lens, P))

    def to_list(self) -> List[Coords]:
        return [self.coords[i, :self.lengths[i]].astype(np.float64)
                for i in range(len(self.lengths))]

    def bounds(self) -> np.ndarray:
        with np.errstate(all="ignore"):
            minxy = np.nanmin(self.coords, axis=1)
            maxxy = np.nanmax(self.coords, axis=1)
        return np.concatenate([minxy, maxxy], axis=1)  # (N, 4)

    def __len__(self) -> int:
        return len(self.lengths)
