"""Exclusion masking (and, later, urban/forest model fusion).

* :func:`fuse_predictions` — the two-model merge; not ported yet, raises.
* :func:`exclude_outlines` — drop crowns within the union of user-supplied
  exclusion shapes such as water/buildings (reference ``helpers.py:33-69``).

Implementation: instead of GEOS unary_union + sjoin, the outline
union is rasterized once per file extent to a coverage mask and crowns are
tested by sampling their vertices + interior grid against it — vectorized,
resolution-bounded (0.5 m default), and robust against invalid geometries
(no ``buffer(0)`` repairs needed).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from treedetection_tpu_torch.geo import Affine
from treedetection_tpu_torch.preprocessing import load_outline_polygons
from treedetection_tpu_torch.vector import read_gpkg, write_gpkg
from treedetection_tpu_torch.vector.polygon import ensure_open, polygons_bounds
from treedetection_tpu_torch.vector.rasterize import rasterize_polygons


class OutlineMask:
    """Rasterized union of outline polygons over a bounded extent."""

    def __init__(self, outlines: Sequence[np.ndarray],
                 bounds: Tuple[float, float, float, float],
                 resolution: float = 0.5):
        minx, miny, maxx, maxy = bounds
        pad = resolution
        minx -= pad; miny -= pad; maxx += pad; maxy += pad
        w = max(int(np.ceil((maxx - minx) / resolution)), 4)
        h = max(int(np.ceil((maxy - miny) / resolution)), 4)
        while w * h > 100_000_000:
            resolution *= 2.0
            w = max(int(np.ceil((maxx - minx) / resolution)), 4)
            h = max(int(np.ceil((maxy - miny) / resolution)), 4)
        self.transform = Affine.from_origin(minx, maxy, resolution, resolution)
        # clip outlines to the extent bbox first: rasterizing country-scale
        # outlines at 0.5 m would explode otherwise
        box = (minx, miny, maxx, maxy)
        from treedetection_tpu_torch.vector.polygon import clip_polygon_box
        clipped = []
        for p in outlines:
            if not len(p):
                continue
            c = clip_polygon_box(p, box)
            if len(c) >= 4:
                clipped.append(c)
        self.mask = rasterize_polygons(clipped, self.transform, (h, w),
                                       dtype=np.uint8).astype(bool)

    def _sample(self, pts: np.ndarray) -> np.ndarray:
        inv = self.transform.invert()
        cols, rows = inv.apply(pts[:, 0], pts[:, 1])
        h, w = self.mask.shape
        c = np.clip(cols.astype(int), 0, w - 1)
        r = np.clip(rows.astype(int), 0, h - 1)
        inside_extent = (cols >= 0) & (cols < w) & (rows >= 0) & (rows < h)
        return self.mask[r, c] & inside_extent

    def polygon_relation(self, ring: np.ndarray) -> Tuple[bool, bool]:
        """-> (intersects_union, within_union) for one crown.

        Full-area test: the crown is rasterized over its bbox at the mask's
        resolution and compared cell-by-cell with the outline coverage.
        Vertex+centroid sampling alone misclassifies an outline island fully
        inside the crown (missed intersection) and a crown whose interior
        spans an outline hole (false ``within``); the reference's GEOS
        ``intersects``/``within`` (``helpers.py:804-812``) handles both.
        """
        r = ensure_open(ring)
        if len(r) == 0:
            return False, False
        from treedetection_tpu_torch.vector.rasterize import rasterize_polygon
        inv = self.transform.invert()
        cols, rows = inv.apply(r[:, 0], r[:, 1])
        h, w = self.mask.shape
        c0 = int(np.floor(cols.min()))
        c1 = int(np.ceil(cols.max())) + 1
        r0 = int(np.floor(rows.min()))
        r1 = int(np.ceil(rows.max())) + 1
        sub_h, sub_w = r1 - r0, c1 - c0
        if sub_h <= 0 or sub_w <= 0:
            return False, False
        t = self.transform
        local = Affine(t.a, t.b, t.c + t.a * c0 + t.b * r0,
                       t.d, t.e, t.f + t.d * c0 + t.e * r0)
        crown = rasterize_polygon(r, local, (sub_h, sub_w))
        if not crown.any():
            # sub-resolution crown: fall back to vertex+centroid sampling
            hits = self._sample(r)
            c_hit = self._sample(r.mean(axis=0, keepdims=True))[0]
            return bool(hits.any() or c_hit), bool(hits.all() and c_hit)
        # outline coverage over the same window (cells beyond the mask
        # extent carry no outline)
        outline = np.zeros((sub_h, sub_w), dtype=bool)
        rr0, rr1 = max(r0, 0), min(r1, h)
        cc0, cc1 = max(c0, 0), min(c1, w)
        if rr1 > rr0 and cc1 > cc0:
            outline[rr0 - r0:rr1 - r0, cc0 - c0:cc1 - c0] = \
                self.mask[rr0:rr1, cc0:cc1]
        inter = crown & outline
        return bool(inter.any()), bool((crown <= outline).all())


def exclude_outlines(gpkg_paths: Sequence[str], exclude_files: Sequence[str],
                     logger=None) -> None:
    """Rewrite each GPKG dropping crowns within any exclusion shape
    (reference ``helpers.py:33-69``; clip-to-bounds then within-union)."""
    if not exclude_files:
        return
    outlines: List[np.ndarray] = []
    for path in exclude_files:
        try:
            outlines.extend(load_outline_polygons(path))
        except (OSError, ValueError) as exc:
            if logger:
                logger.error(f"Cannot load exclusion file {path}: {exc}")
    if not outlines:
        return
    for gp in gpkg_paths:
        if not os.path.exists(gp):
            continue
        geoms, props, srs = read_gpkg(gp)
        rings = [np.asarray(g[0][0]) for g in geoms if g and g[0]]
        kept_props = [p for g, p in zip(geoms, props) if g and g[0]]
        if not rings:
            continue
        b = polygons_bounds(rings)
        file_bounds = (b[:, 0].min(), b[:, 1].min(), b[:, 2].max(), b[:, 3].max())
        mask = OutlineMask(outlines, file_bounds)
        keep_geoms, keep_props = [], []
        dropped = 0
        for ring, p in zip(rings, kept_props):
            _, within = mask.polygon_relation(ring)
            if within:
                dropped += 1
                continue
            keep_geoms.append(ring)
            keep_props.append(p)
        write_gpkg(gp, keep_geoms, keep_props, srs_id=srs)
        if logger:
            logger.info(f"Excluded {dropped} crowns from {os.path.basename(gp)}")


def fuse_predictions(config: Dict[str, Any],
                     urban_gpkgs: Sequence[str],
                     forest_gpkgs: Sequence[str],
                     forest_outline: str,
                     output_dir: str) -> List[str]:
    """Merge urban + forest model outputs per image.  Not ported yet."""
    raise NotImplementedError(
        "two-model fusion (fuse_predictions) is not ported yet; run with "
        "'combined_model'")
