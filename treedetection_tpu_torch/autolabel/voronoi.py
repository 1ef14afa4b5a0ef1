"""Voronoi crown autolabels from nDSM height rasters.

Counterpart of ``treedetection_tpu/autolabel/voronoi.py``.  Pipeline parity
with reference ``supplementary/pretraining_generate_voronoi.py``
(``:59-74,112-165,294-331``):

1. gaussian smooth (sigma 0.5)
2. canopy threshold (2.5 m)
3. crown seeds = local height maxima (7x7 window, min height 3 m)
4. Voronoi partition of canopy pixels by nearest seed (discretized — each
   above-threshold pixel joins its nearest seed's cell, which is exactly the
   Voronoi cell membership without constructing cell polygons)
5. per-cell connected component containing the seed -> convex hull
6. keep cells with >= 20% of their pixels above the canopy threshold

The blur and the local-maximum test run on the caller's device (``device``,
the card by default); the partition uses a KD-tree on the host.  Outputs a
GPKG of crown polygons.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from treedetection_tpu_torch.config import select_device
from treedetection_tpu_torch.geo import GeoTiff
from treedetection_tpu_torch.vector import write_gpkg


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable gaussian blur of an (H, W) float32 tensor with zero
    padding, on its device.

    Each pass is a weighted sum of shifted slices taken in a fixed order,
    one elementwise multiply and one add per tap: exact float32 on any
    device (a convolution would take TF32 on the card where that is
    enabled, and its own summation order)."""
    radius = max(int(3 * sigma + 0.5), 1)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    taps = (k / k.sum()).tolist()
    h, w = img.shape

    def one_pass(a: torch.Tensor, rows: bool) -> torch.Tensor:
        pad = F.pad(a, (0, 0, radius, radius) if rows else
                    (radius, radius, 0, 0))
        out = None
        for t, wt in enumerate(taps):
            term = (pad[t:t + h] if rows else pad[:, t:t + w]) * wt
            out = term if out is None else out + term
        return out

    return one_pass(one_pass(img, rows=True), rows=False)


def find_crown_seeds(height: torch.Tensor, sigma: float = 0.5,
                     window: int = 7, min_height: float = 3.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (smoothed height, bool seed mask) on ``height``'s device: local
    maxima of the smoothed (H, W) float32 height above ``min_height``
    (reference ``:59-74``).  The window's max pads with -inf."""
    smooth = gaussian_blur(height, sigma)
    pooled = F.max_pool2d(smooth[None, None], kernel_size=window, stride=1,
                          padding=window // 2)[0, 0]
    seeds = (smooth >= pooled) & (smooth >= min_height)
    return smooth, seeds


def read_height(height_path: str):
    """nDSM GeoTIFF -> (float32 (H, W) height with nodata as 0, transform,
    EPSG code, 25832 when the file names none)."""
    g = GeoTiff(height_path)
    height = g.read()[:, :, 0].astype(np.float32)
    if g.nodata is not None:
        height = np.where(height == g.nodata, 0.0, height)
    transform = g.transform
    crs = g.crs or 25832
    g.close()
    return height, transform, crs


def height_seeds(height: np.ndarray, sigma: float, window: int,
                 min_height: float, device) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`find_crown_seeds` of a host height raster on ``device`` ->
    (smoothed height, (S, 2) seed rows and columns in row-major order: the
    seed index is the Voronoi owner id, and the KD-tree's ties go by it)."""
    t = torch.from_numpy(np.ascontiguousarray(height, dtype=np.float32))
    smooth, seeds = find_crown_seeds(t.to(select_device(device)), sigma,
                                     window, min_height)
    return smooth.cpu().numpy(), np.argwhere(seeds.cpu().numpy())


def generate_voronoi_labels(height_path: str, out_gpkg: str,
                            canopy_threshold: float = 2.5,
                            min_seed_height: float = 3.0,
                            sigma: float = 0.5,
                            window: int = 7,
                            coverage: float = 0.2,
                            min_cell_pixels: int = 4,
                            logger=None, device="cuda") -> int:
    """nDSM GeoTIFF -> crown-polygon GPKG; returns the crown count
    (reference ``process_files``, ``:294-331``).  The seeds are found on
    ``device``."""
    from scipy.spatial import cKDTree
    from scipy.ndimage import label as cc_label
    from scipy.spatial import ConvexHull, QhullError

    height, transform, crs = read_height(height_path)
    smooth, seed_rc = height_seeds(height, sigma, window, min_seed_height,
                                   device)
    if len(seed_rc) == 0:
        write_gpkg(out_gpkg, [], [], srs_id=crs)
        return 0

    canopy = smooth >= canopy_threshold
    canopy_rc = np.argwhere(canopy)
    tree = cKDTree(seed_rc)
    _, owner = tree.query(canopy_rc, k=1)

    crowns: List[np.ndarray] = []
    props: List[Dict[str, Any]] = []
    h, w = height.shape
    cell_ids = np.full((h, w), -1, dtype=np.int32)
    cell_ids[canopy_rc[:, 0], canopy_rc[:, 1]] = owner

    # group canopy pixels by owning seed ONCE (argsort + slice): a per-seed
    # np.where(cell_ids == s) rescans the whole raster per seed — O(S * H*W),
    # hours on county mosaics with ~50k seeds
    order = np.argsort(owner, kind="stable")
    sorted_rc = canopy_rc[order]
    sorted_owner = owner[order]
    uniq, starts = np.unique(sorted_owner, return_index=True)
    ends = np.append(starts[1:], len(sorted_owner))
    cell_pixels = {int(s): sorted_rc[a:b]
                   for s, a, b in zip(uniq, starts, ends)}

    for s in range(len(seed_rc)):
        rc = cell_pixels.get(s)
        if rc is None or len(rc) < min_cell_pixels:
            continue
        rows, cols = rc[:, 0], rc[:, 1]
        # connected component containing the seed (reference keeps the
        # seed-connected blob per cell, :112-165)
        r0, r1 = rows.min(), rows.max() + 1
        c0, c1 = cols.min(), cols.max() + 1
        sub = (cell_ids[r0:r1, c0:c1] == s)
        labeled, _ = cc_label(sub)
        sr, sc = seed_rc[s]
        seed_lab = labeled[sr - r0, sc - c0] if (r0 <= sr < r1 and c0 <= sc < c1) else 0
        if seed_lab == 0:
            continue
        comp = labeled == seed_lab
        comp_rc = np.argwhere(comp)
        if len(comp_rc) < min_cell_pixels:
            continue
        # coverage check: >= 20% of the component's pixels above threshold
        vals = height[r0:r1, c0:c1][comp]
        if (vals >= canopy_threshold).mean() < coverage:
            continue
        pts = comp_rc[:, ::-1].astype(np.float64) + np.array([c0, r0])
        try:
            hull = ConvexHull(pts)
            ring_px = pts[hull.vertices]
        except (QhullError, ValueError):
            continue
        gx, gy = transform.apply(ring_px[:, 0] + 0.5, ring_px[:, 1] + 0.5)
        ring = np.stack([gx, gy], axis=1)
        crowns.append(ring)
        sx, sy = transform.apply(float(sc) + 0.5, float(sr) + 0.5)
        props.append({
            "seed_height": float(smooth[sr, sc]),
            "seed_x": float(sx), "seed_y": float(sy),
            "pixels": int(comp.sum()),
        })

    write_gpkg(out_gpkg, crowns, props, srs_id=crs)
    if logger:
        logger.info(f"Voronoi autolabels: {len(crowns)} crowns from "
                    f"{len(seed_rc)} seeds in {os.path.basename(height_path)}")
    return len(crowns)
