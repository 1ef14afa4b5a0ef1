"""Batched polygon raster statistics on the device.

Counterpart of ``treedetection_tpu/ops/stats.py``: every polygon gets a fixed
SxS sample grid over its bbox; grid points are tested against the polygon
edges (exact even-odd PIP) and the raster is bilinearly sampled at the inside
points.  Stats (max + argmax location, min, mean, var) are masked reductions.

Shapes: polygons (N, P, 2) NaN-padded, raster (H, W).  All tensors of a call
lie on one device (the polygons' device); nothing moves between devices here.

Memory: the point-in-polygon test materialises (chunk, S*S, P) temporaries,
so every stats function walks the polygons ``CHUNK`` at a time and runs the
test, the sampling and the reductions inside that loop; only the (N,) results
are concatenated.

Matrix products (the two hat-matrix contractions of the patch path) are
float32 ``torch.einsum`` and expect TF32 off
(``torch.backends.cuda.matmul.allow_tf32`` is False by default).

A ``compat_circle`` flag reproduces the reference's bounding-circle
approximation for output-parity testing.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence, Tuple

import torch

CHUNK = 256


class PolygonStats(NamedTuple):
    max: torch.Tensor        # (N,)
    min: torch.Tensor        # (N,)
    mean: torch.Tensor       # (N,)
    var: torch.Tensor        # (N,)
    argmax_xy: torch.Tensor  # (N, 2) geo coords of the max sample
    count: torch.Tensor      # (N,) inside-sample count


def _nanmin(x: torch.Tensor, dim: int) -> torch.Tensor:
    """NaN-ignoring min; NaN where every entry is NaN (as ``jnp.nanmin``)."""
    nan = torch.isnan(x)
    out = torch.where(nan, torch.full_like(x, float("inf")), x).amin(dim)
    return torch.where(nan.all(dim), torch.full_like(out, float("nan")), out)


def _nanmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    nan = torch.isnan(x)
    out = torch.where(nan, torch.full_like(x, float("-inf")), x).amax(dim)
    return torch.where(nan.all(dim), torch.full_like(out, float("nan")), out)


def points_in_polygons(points: torch.Tensor, polys: torch.Tensor
                       ) -> torch.Tensor:
    """Even-odd PIP: points (N, M, 2) vs NaN-padded polys (N, P, 2) -> (N, M)
    bool."""
    x = points[..., 0][:, :, None]                    # (N, M, 1)
    y = points[..., 1][:, :, None]
    x1 = polys[:, None, :, 0]                         # (N, 1, P)
    y1 = polys[:, None, :, 1]
    x2 = torch.roll(polys[:, :, 0], -1, dims=1)[:, None, :]
    y2 = torch.roll(polys[:, :, 1], -1, dims=1)[:, None, :]
    # padded vertices (NaN) produce NaN comparisons -> False, and the roll
    # seam edge (last real vertex -> first vertex) is handled by masking:
    valid_edge = torch.isfinite(x1) & torch.isfinite(x2)
    cond = ((y1 > y) != (y2 > y)) & valid_edge
    slope = (x2 - x1) / (y2 - y1)
    xint = x1 + (y - y1) * slope
    crossings = (cond & (x < xint)).sum(dim=-1)
    return (crossings % 2) == 1


def _close_rings(polys: torch.Tensor) -> torch.Tensor:
    """Append each ring's first vertex at its first NaN slot so the roll seam
    closes the ring correctly.  A ring with NO pad slot (all P vertices
    finite) is left untouched."""
    n, p, _ = polys.shape
    lengths = torch.isfinite(polys[:, :, 0]).sum(dim=1)    # (N,)
    idx = lengths.clamp(0, p - 1)
    rows = torch.arange(n, device=polys.device)
    keep = (lengths >= p)[:, None]
    closed = polys.clone()
    closed[rows, idx] = torch.where(keep, polys[rows, idx], polys[:, 0, :])
    return closed


def _grid_axes(polys: torch.Tensor, grid: int):
    """Per-polygon sample coordinates along x and y, (N, G) each, and the
    bbox span (N, 2)."""
    minxy = _nanmin(polys, 1)                         # (N, 2)
    maxxy = _nanmax(polys, 1)
    span = torch.clamp(maxxy - minxy, min=1e-6)
    t = (torch.arange(grid, dtype=polys.dtype, device=polys.device) + 0.5) / grid
    gx = minxy[:, None, 0] + t[None, :] * span[:, None, 0]   # (N, G)
    gy = minxy[:, None, 1] + t[None, :] * span[:, None, 1]
    return gx, gy, span


def sample_grid_over_bboxes(polys: torch.Tensor, grid: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, grid*grid, 2) sample points covering each polygon's bbox, plus the
    per-polygon (cell_w * cell_h) sample footprint area."""
    n = polys.shape[0]
    gx, gy, span = _grid_axes(polys, grid)
    px = gx[:, None, :].expand(n, grid, grid)
    py = gy[:, :, None].expand(n, grid, grid)
    pts = torch.stack([px.reshape(n, grid * grid),
                       py.reshape(n, grid * grid)], dim=-1)
    cell_area = (span[:, 0] / grid) * (span[:, 1] / grid)
    return pts, cell_area


def _floor_index(x: torch.Tensor, hi: int) -> torch.Tensor:
    """floor(x) as an index clamped to [0, hi] (NaN -> 0)."""
    return torch.nan_to_num(torch.floor(x), nan=0.0).clamp(0, hi).long()


def bilinear_sample_raster(raster: torch.Tensor, affine: torch.Tensor,
                           pts: torch.Tensor) -> torch.Tensor:
    """Sample raster (H, W) at geo points (..., 2) under affine (6,) —
    pixel-center convention; out-of-raster samples return NaN."""
    a, b, c, d, e, f = (affine[i] for i in range(6))
    det = a * e - b * d
    col = (e * (pts[..., 0] - c) - b * (pts[..., 1] - f)) / det
    row = (-d * (pts[..., 0] - c) + a * (pts[..., 1] - f)) / det
    # pixel centers at (col - 0.5, row - 0.5) in index space
    ci = col - 0.5
    ri = row - 0.5
    h, w = raster.shape
    inside = (ci >= -0.5) & (ci <= w - 0.5) & (ri >= -0.5) & (ri <= h - 0.5)
    c0 = _floor_index(ci, w - 1)
    r0 = _floor_index(ri, h - 1)
    c1 = torch.clamp(c0 + 1, max=w - 1)
    r1 = torch.clamp(r0 + 1, max=h - 1)
    lc = torch.clamp(ci - c0, 0.0, 1.0)
    lr = torch.clamp(ri - r0, 0.0, 1.0)
    v = (raster[r0, c0] * (1 - lr) * (1 - lc) + raster[r0, c1] * (1 - lr) * lc
         + raster[r1, c0] * lr * (1 - lc) + raster[r1, c1] * lr * lc)
    return torch.where(inside, v, torch.full_like(v, float("nan")))


def _inside_mask(polys: torch.Tensor, pts: torch.Tensor,
                 compat_circle: bool) -> torch.Tensor:
    if compat_circle:
        # reference semantics: a point counts as inside when within the
        # polygon's bounding circle (utilities.py:78-98)
        center = (_nanmin(polys, 1) + _nanmax(polys, 1)) / 2
        d2 = torch.nansum((polys - center[:, None, :]) ** 2, dim=-1)
        radius2 = torch.where(torch.isfinite(polys[..., 0]), d2,
                              torch.full_like(d2, float("-inf"))).amax(dim=1)
        dist2 = ((pts - center[:, None, :]) ** 2).sum(dim=-1)
        return dist2 <= radius2[:, None]
    return points_in_polygons(pts, _close_rings(polys))


def _masked_stats(inside: torch.Tensor, vals: torch.Tensor,
                  pts: torch.Tensor) -> PolygonStats:
    ok = inside & torch.isfinite(vals)
    count = ok.sum(dim=1)
    has = count > 0
    denom = count.clamp(min=1).to(vals.dtype)
    zero = torch.zeros_like(vals)
    minus1 = torch.full_like(denom, -1.0)
    s = torch.where(ok, vals, zero).sum(dim=1)
    mean = torch.where(has, s / denom, minus1)
    var = torch.where(
        has,
        torch.where(ok, (vals - mean[:, None]) ** 2, zero).sum(dim=1) / denom,
        minus1)
    neg = torch.where(ok, vals, torch.full_like(vals, float("-inf")))
    mx = neg.amax(dim=1)
    # the FIRST maximum, as jnp.argmax returns it
    m = vals.shape[1]
    order = torch.arange(m, device=vals.device)
    argmax = torch.where(neg == mx[:, None], order,
                         torch.full_like(order, m)).amin(dim=1)
    mx = torch.where(has, mx, minus1)
    mn = torch.where(
        has,
        torch.where(ok, vals, torch.full_like(vals, float("inf"))).amin(dim=1),
        minus1)
    argmax_xy = torch.take_along_dim(pts, argmax[:, None, None], dim=1)[:, 0, :]
    return PolygonStats(max=mx, min=mn, mean=mean, var=var,
                        argmax_xy=argmax_xy, count=count)


def _check_devices(polys: torch.Tensor, *others: torch.Tensor) -> None:
    for t in others:
        if t.device != polys.device:
            raise ValueError(f"tensors on {t.device} and {polys.device}: the "
                             f"stats run on one device")


Sampler = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _chunked_stats(polys: torch.Tensor, samplers: Sequence[Sampler],
                   grid: int, compat_circle: bool) -> List[PolygonStats]:
    """The shared core: per chunk of polygons, build the sample grid, run the
    point-in-polygon test ONCE, then for every sampler (one per raster;
    ``sampler(polys_chunk, pts_chunk) -> vals (K, G*G)``) reduce the masked
    stats.  -> one PolygonStats per sampler."""
    n = polys.shape[0]
    parts: List[List[PolygonStats]] = [[] for _ in samplers]
    for s in range(0, max(n, 1), CHUNK):
        pc = polys[s:s + CHUNK]
        pts, _ = sample_grid_over_bboxes(pc, grid)
        inside = _inside_mask(pc, pts, compat_circle)
        for out, sampler in zip(parts, samplers):
            out.append(_masked_stats(inside, sampler(pc, pts), pts))
    return [PolygonStats(*[torch.cat(field) for field in zip(*chunks)])
            for chunks in parts]


def _gather_sampler(raster: torch.Tensor, affine: torch.Tensor) -> Sampler:
    return lambda pc, pts: bilinear_sample_raster(raster, affine, pts)


def polygon_raster_stats_batch(polys: torch.Tensor, raster: torch.Tensor,
                               affine: torch.Tensor, grid: int = 32,
                               compat_circle: bool = False) -> PolygonStats:
    """Masked raster stats for every polygon (gather path).

    ``polys``: (N, P, 2) NaN-padded exterior rings (geo coords);
    ``raster``: (H, W) float; ``affine``: 6-vector pixel->geo transform.
    """
    _check_devices(polys, raster, affine)
    return _chunked_stats(polys, [_gather_sampler(raster, affine)], grid,
                          compat_circle)[0]


def polygon_raster_stats_two(polys: torch.Tensor,
                             raster_a: torch.Tensor, affine_a: torch.Tensor,
                             raster_b: torch.Tensor, affine_b: torch.Tensor,
                             grid: int = 32, compat_circle: bool = False
                             ) -> Tuple[PolygonStats, PolygonStats]:
    """Stats against TWO rasters (height + NDVI) with the polygon sample grid
    and the even-odd PIP test — the dominant compute — shared; each raster is
    sampled through its own affine.  Exactly
    ``(polygon_raster_stats_batch(polys, a), ..._batch(polys, b))``."""
    _check_devices(polys, raster_a, affine_a, raster_b, affine_b)
    out = _chunked_stats(polys, [_gather_sampler(raster_a, affine_a),
                                 _gather_sampler(raster_b, affine_b)],
                         grid, compat_circle)
    return out[0], out[1]


def _separable_sample_coords(polys: torch.Tensor, affine: torch.Tensor,
                             grid: int):
    """Per-polygon separable pixel-space sample coordinates for an
    AXIS-ALIGNED affine (b == d == 0): the (grid x grid) geo sample grid of
    ``sample_grid_over_bboxes`` maps to per-axis pixel coords
    ``cix`` (N, G) columns / ``riy`` (N, G) rows, with the same
    pixel-center convention and inside test as
    :func:`bilinear_sample_raster`."""
    a, c, e, f = affine[0], affine[2], affine[4], affine[5]
    gx, gy, _ = _grid_axes(polys, grid)
    cix = (gx - c) / a - 0.5
    riy = (gy - f) / e - 0.5
    return cix, riy


def _patch_prep(raster: torch.Tensor, cix: torch.Tensor, riy: torch.Tensor,
                patch: int):
    """Per-polygon patch-pooling geometry for the separable sample grid:
    in-raster sample mask (N, G*G), clamped window origins (N,), and the
    row/col hat matrices (N, G, patch) that evaluate the bilinear samples
    as two matmuls against the (patch, patch) window.

    Exact vs :func:`bilinear_sample_raster` for every sample whose clipped
    pixel coord lies within its polygon's window (callers route wider
    polygons through the gather path); out-of-raster samples are masked,
    edge samples clamp to the border pixel, both identical to the gather
    path."""
    h, w = raster.shape
    n, g = cix.shape
    inr = ((cix[:, None, :] >= -0.5) & (cix[:, None, :] <= w - 0.5)
           & (riy[:, :, None] >= -0.5) & (riy[:, :, None] <= h - 0.5))
    # clamped coords reproduce the gather path's border-pixel duplication
    cc = torch.clamp(cix, 0.0, w - 1.0)
    rr = torch.clamp(riy, 0.0, h - 1.0)
    oc = _floor_index(cc.amin(dim=1), max(w - patch, 0))
    orr = _floor_index(rr.amin(dim=1), max(h - patch, 0))
    relc = cc - oc.to(cc.dtype)[:, None]                  # (N, G)
    relr = rr - orr.to(rr.dtype)[:, None]
    cols = torch.arange(patch, dtype=cc.dtype, device=cc.device)
    hat_c = torch.clamp(1.0 - (relc[..., None] - cols).abs(), min=0.0)
    hat_r = torch.clamp(1.0 - (relr[..., None] - cols).abs(), min=0.0)
    return inr.reshape(n, g * g), oc, orr, hat_r, hat_c


def _patch_sampler(raster: torch.Tensor, affine: torch.Tensor, patch: int,
                   grid: int) -> Sampler:
    """Bilinear sampling via per-polygon raster windows + hat-matrix
    contractions (no scattered 4-tap gathers)."""
    h, w = raster.shape
    if patch > h or patch > w:
        raise ValueError(f"patch {patch} exceeds the raster {h}x{w}")
    span = torch.arange(patch, device=raster.device)

    def sample(pc: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
        cix, riy = _separable_sample_coords(pc, affine, grid)
        inr, oc, orr, hat_r, hat_c = _patch_prep(raster, cix, riy, patch)
        rows = orr[:, None] + span                            # (K, p)
        cols = oc[:, None] + span
        p_ = raster[rows[:, :, None], cols[:, None, :]]       # (K, p, p)
        # NaN (nodata) cells: the gather path NaNs exactly the samples with a
        # positive-weight NaN tap; a raw matmul would contaminate every
        # sample of the polygon (0 * NaN = NaN), so contract a NaN-indicator
        # alongside and re-mark
        finite = torch.isfinite(p_)
        pz = torch.where(finite, p_, torch.zeros_like(p_))
        t1 = torch.einsum("kgp,kpq->kgq", hat_r, pz)
        v = torch.einsum("kgq,khq->kgh", t1, hat_c)           # (K, Gy, Gx)
        tn = torch.einsum("kgp,kpq->kgq", hat_r, (~finite).to(pz.dtype))
        wn = torch.einsum("kgq,khq->kgh", tn, hat_c)
        nan = torch.full_like(v, float("nan"))
        vals = torch.where(wn > 0, nan, v).reshape(inr.shape)
        return torch.where(inr, vals, nan.reshape(inr.shape))

    return sample


def polygon_raster_stats_batch_patch(polys: torch.Tensor, raster: torch.Tensor,
                                     affine: torch.Tensor, grid: int = 32,
                                     patch: int = 64,
                                     compat_circle: bool = False
                                     ) -> PolygonStats:
    """Patch-path twin of :func:`polygon_raster_stats_batch` for
    AXIS-ALIGNED affines and polygons whose clipped pixel bbox fits a
    (patch, patch) window (the caller routes the rest to the gather path).
    Identical results where those preconditions hold."""
    _check_devices(polys, raster, affine)
    return _chunked_stats(polys, [_patch_sampler(raster, affine, patch, grid)],
                          grid, compat_circle)[0]


def polygon_raster_stats_two_patch(polys: torch.Tensor,
                                   raster_a: torch.Tensor,
                                   affine_a: torch.Tensor,
                                   raster_b: torch.Tensor,
                                   affine_b: torch.Tensor,
                                   grid: int = 32, patch_a: int = 64,
                                   patch_b: int = 64,
                                   compat_circle: bool = False
                                   ) -> Tuple[PolygonStats, PolygonStats]:
    """Patch-path twin of :func:`polygon_raster_stats_two` (shared PIP,
    per-raster patches/hats)."""
    _check_devices(polys, raster_a, affine_a, raster_b, affine_b)
    out = _chunked_stats(
        polys, [_patch_sampler(raster_a, affine_a, patch_a, grid),
                _patch_sampler(raster_b, affine_b, patch_b, grid)],
        grid, compat_circle)
    return out[0], out[1]


def polygon_areas_batch(polys: torch.Tensor) -> torch.Tensor:
    """Shoelace areas of NaN-padded rings (N, P, 2) -> (N,)."""
    closed = _close_rings(polys)
    x = closed[..., 0]
    y = closed[..., 1]
    xn = torch.roll(x, -1, dims=1)
    yn = torch.roll(y, -1, dims=1)
    term = x * yn - xn * y
    term = torch.where(torch.isfinite(term), term, torch.zeros_like(term))
    return term.sum(dim=1).abs() / 2.0


def polygon_centroids_batch(polys: torch.Tensor) -> torch.Tensor:
    """NaN-aware vertex centroids (N, 2): the mean of the vertices."""
    return torch.stack([torch.nanmean(polys[..., 0], dim=1),
                        torch.nanmean(polys[..., 1], dim=1)], dim=-1)
