"""Compatibility surface: the reference's exported-but-auxiliary helpers.

The port's own copy of the JAX package's ``compat.py`` (numpy only).  The
reference's ``helpers.py`` exports several functions that tooling built
around it may call even though the main ``process_files`` path doesn't:
COCO-RLE mask decoding (``polygon_from_mask``, ``helpers.py:71-95``),
detectree2-style crown IoU-dedupe (``clean_crowns``, ``helpers.py:602-701``),
border proximity (``element_is_near_border``, ``helpers.py:478-522``), and
the older projection path (``project_to_geojson``, ``helpers.py:115-263``).
These are the first-party equivalents (pycocotools' C RLE codec becomes a
numpy run-length cumsum).  ``stitching.stitch_tile_file`` uses the RLE
decoder for detectree2-format prediction files.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from treedetection_tpu_torch.geo import Affine
from treedetection_tpu_torch.vector.polygon import polygon_area, polygons_bounds


# --- COCO RLE ---------------------------------------------------------------

def rle_decode(rle: Dict[str, Any]) -> np.ndarray:
    """COCO RLE -> (H, W) uint8 mask.

    Supports uncompressed RLE (``counts`` as list) and compressed LEB128-style
    string RLE (the pycocotools ``counts`` string format).  Column-major
    (Fortran) order per COCO spec.
    """
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = _rle_string_decode(counts.encode() if isinstance(counts, str)
                                    else counts)
    elif isinstance(counts, bytes):
        counts = _rle_string_decode(counts)
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    flat = np.zeros(h * w, dtype=np.uint8)
    ends = np.cumsum(counts)
    starts = ends - counts
    for i in range(1, len(counts), 2):  # odd runs are foreground
        flat[starts[i]:ends[i]] = 1
    return flat[:h * w].reshape(w, h).T  # column-major


def _rle_string_decode(data: bytes) -> List[int]:
    """pycocotools compressed counts: LEB128 variant with delta coding."""
    counts: List[int] = []
    pos = 0
    while pos < len(data):
        x = 0
        k = 0
        more = True
        while more:
            c = data[pos] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            pos += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_encode(mask: np.ndarray) -> Dict[str, Any]:
    """(H, W) binary mask -> uncompressed COCO RLE (column-major)."""
    flat = np.asarray(mask, dtype=np.uint8).T.reshape(-1)
    changes = np.flatnonzero(np.diff(flat)) + 1
    boundaries = np.concatenate([[0], changes, [len(flat)]])
    counts = np.diff(boundaries).tolist()
    if flat[0] == 1:  # RLE starts with a background run
        counts = [0] + counts
    return {"size": list(mask.shape), "counts": counts}


def polygon_from_mask(mask: np.ndarray) -> List[float]:
    """Binary mask -> flat [x0, y0, x1, y1, ...] polygon of the largest
    contour (reference ``helpers.py:71-95`` semantics)."""
    from treedetection_tpu_torch.native import trace_contours
    rings = trace_contours(np.asarray(mask, dtype=np.uint8),
                           include_holes=False)
    if not rings:
        return []
    ring = max(rings, key=lambda r: polygon_area(r.astype(np.float64)))
    closed = np.vstack([ring, ring[:1]])
    return closed.reshape(-1).astype(float).tolist()


# --- crown utilities ---------------------------------------------------------

def element_is_near_border(bounds: Sequence[float],
                           raster_bounds: Sequence[float],
                           eps: float = 1.0) -> bool:
    """True when a bbox lies within eps of the raster border (reference
    ``helpers.py:478-522``; defined twice there — the semantics are
    identical)."""
    minx, miny, maxx, maxy = bounds
    left, bottom, right, top = raster_bounds
    return (minx - left < eps or right - maxx < eps
            or miny - bottom < eps or top - maxy < eps)


def clean_crowns(crowns: Sequence[np.ndarray], scores: Sequence[float],
                 iou_threshold: float = 0.7,
                 confidence: float = 0.2) -> Tuple[List[np.ndarray], List[float]]:
    """detectree2-style crown cleaning (reference ``helpers.py:602-701``):
    for overlapping groups (IoU > threshold) keep the highest-confidence
    crown, then drop crowns below the confidence floor."""
    if not crowns:
        return [], []
    from treedetection_tpu_torch.vector.polygon import polygon_iou
    n = len(crowns)
    bounds = polygons_bounds(crowns)
    scores_arr = np.asarray(scores, dtype=np.float64)
    order = np.argsort(-scores_arr)
    suppressed = np.zeros(n, dtype=bool)
    for oi, i in enumerate(order):
        if suppressed[i]:
            continue
        for j in order[oi + 1:]:
            if suppressed[j]:
                continue
            if (bounds[i, 0] > bounds[j, 2] or bounds[j, 0] > bounds[i, 2] or
                    bounds[i, 1] > bounds[j, 3] or bounds[j, 1] > bounds[i, 3]):
                continue
            if polygon_iou(crowns[i], crowns[j]) > iou_threshold:
                suppressed[j] = True
    keep = [i for i in range(n)
            if not suppressed[i] and scores_arr[i] >= confidence]
    return [crowns[i] for i in keep], [float(scores_arr[i]) for i in keep]


def project_to_geojson(tile_prediction_files: Sequence[str],
                       tile_meta: Dict[str, Dict[str, Any]],
                       out_dir: str) -> List[str]:
    """Older projection path (reference ``helpers.py:115-263``): per tile
    prediction file, georeference the polygons (or RLE masks) and write one
    GeoJSON per tile."""
    from treedetection_tpu_torch.vector.geojson import write_geojson
    os.makedirs(out_dir, exist_ok=True)
    outputs = []
    for path in tile_prediction_files:
        tile_id = os.path.basename(path).replace("Prediction_", "").replace(".json", "")
        meta = tile_meta.get(tile_id)
        if meta is None:
            continue
        transform = Affine(*meta["transform"])
        with open(path) as fh:
            preds = json.load(fh)
        geoms, props = [], []
        for p in preds:
            if "polygon_coords" in p and p["polygon_coords"]:
                ring = np.asarray(p["polygon_coords"][0], dtype=np.float64)
            elif "segmentation" in p:
                flat = polygon_from_mask(rle_decode(p["segmentation"]))
                if not flat:
                    continue
                px = np.asarray(flat, dtype=np.float64).reshape(-1, 2)
                gx, gy = transform.apply(px[:, 0], px[:, 1])
                ring = np.stack([gx, gy], axis=1)
            else:
                continue
            geoms.append(ring)
            props.append({"Confidence_score": p.get("score", 0.0)})
        out = os.path.join(out_dir, f"{tile_id}.geojson")
        write_geojson(out, geoms, props, crs_epsg=meta.get("crs"))
        outputs.append(out)
    return outputs


def stitch_crowns(folder: str, shift: float = 1.0,
                  simplify_tolerance: float = 0.2, logger=None
                  ) -> Tuple[List[np.ndarray], List[Dict[str, Any]], int]:
    """detectree2-style stitcher over per-tile GPKG files (reference
    ``helpers.py:321-408``; dead code on the reference's own
    ``process_files`` path but part of its public surface).

    Reads every ``*.gpkg`` in ``folder`` (files named with the tile-id
    schema), keeps crowns fully within the tile box shrunk inward by
    ``shift`` meters, simplifies rings, and concatenates.  Returns
    ``(geoms, props, srs_id)`` with the CRS parsed from the first filename —
    the first-party equivalent of the reference's GeoDataFrame return.
    """
    import glob as _glob
    from treedetection_tpu_torch.stitching import filename_geoinfo, shrunk_tile_box
    from treedetection_tpu_torch.vector import read_gpkg, simplify_polygon
    from treedetection_tpu_torch.vector.polygon import ensure_open

    files = sorted(_glob.glob(os.path.join(folder, "*.gpkg")))
    if not files:
        raise FileNotFoundError(f"No gpkg files found in folder {folder}.")
    srs_id = filename_geoinfo(files[0])[4]
    all_geoms: List[np.ndarray] = []
    all_props: List[Dict[str, Any]] = []
    for f in files:
        try:
            geoms, props, _ = read_gpkg(f)
            bminx, bminy, bmaxx, bmaxy = shrunk_tile_box(f, shift)
            for g, p in zip(geoms, props):
                if not g or not g[0]:
                    continue
                r = ensure_open(np.asarray(g[0][0], dtype=np.float64))
                if not (r[:, 0].min() >= bminx and r[:, 0].max() <= bmaxx
                        and r[:, 1].min() >= bminy
                        and r[:, 1].max() <= bmaxy):
                    continue
                if simplify_tolerance > 0:
                    r = simplify_polygon(r, simplify_tolerance)
                all_geoms.append(r)
                all_props.append(dict(p))
        except Exception as exc:  # keep-batch-alive, like the reference
            if logger:
                logger.warning(f"An error occurred while processing {f}: {exc}")
    if not all_geoms:
        raise RuntimeError("No valid crowns were processed.")
    return all_geoms, all_props, srs_id
