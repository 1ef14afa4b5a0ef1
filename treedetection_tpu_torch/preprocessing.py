"""Stage 1 — tiling: metadata-only tile planning over raster bounds.

Counterpart of ``treedetection_tpu/preprocessing.py``: walk the raster bounds
in ``tile_width`` x ``tile_height`` geo-unit steps, per tile compute the
buffered bbox, the forest/urban coverage flags and the pixel-window
transform, and write ONE JSON per image mapping ``tile_id -> {crs, transform,
bounds, only_forest, only_urban}``.  The tile-id format and the metadata
schema are byte-identical to the JAX package's.  No pixel data is written —
the Predictor re-crops from the source raster.

All tile flags of an image come from one vectorized numpy broadcast (tiles x
forest-regions bbox matrix), with precise coverage resolved by rasterizing
the candidate forest polygons once per image.  The tiling manifest
(``recovery.yaml``) goes through ``flatyaml``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from treedetection_tpu_torch import flatyaml
from treedetection_tpu_torch.geo import Affine, GeoTiff
from treedetection_tpu_torch.vector.polygon import polygons_bounds
from treedetection_tpu_torch.vector.rasterize import rasterize_polygons


def tile_grid(bounds: Tuple[float, float, float, float],
              tile_width: float, tile_height: float) -> Tuple[np.ndarray, np.ndarray]:
    """(minx, miny) arrays of the tile grid over raster bounds — same stepping
    as the reference's double ``np.arange`` loop (reference
    ``preprocessing.py:57-58``)."""
    xs = np.arange(bounds[0], bounds[2], tile_width)
    ys = np.arange(bounds[1], bounds[3], tile_height)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    return gx.ravel(), gy.ravel()


def compute_forest_flags(tile_minx: np.ndarray, tile_miny: np.ndarray,
                         tile_width: float, tile_height: float, buffer: float,
                         forest_polys: Optional[Sequence[np.ndarray]],
                         coverage_resolution: float = 2.0
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Batched only_forest / only_urban flags for all tiles of one image.

    Semantics follow reference ``preprocessing.py:69-96``:
    * only_urban  = no forest region intersects the tile's *buffered* bbox
    * only_forest = the union of intersecting forest regions fully covers the
      buffered bbox

    Implementation: one (T, F) bbox-overlap matrix; precise coverage via a
    single rasterized forest mask over the image extent at
    ``coverage_resolution`` (meters/px) — a tile is only_forest when every
    mask pixel in its buffered bbox is forest.  All-array math; no per-tile
    host loops.
    """
    T = len(tile_minx)
    only_forest = np.zeros(T, dtype=bool)
    only_urban = np.zeros(T, dtype=bool)
    if not forest_polys:
        return only_forest, only_urban

    bx0 = tile_minx - buffer
    by0 = tile_miny - buffer
    bx1 = tile_minx + tile_width + buffer
    by1 = tile_miny + tile_height + buffer

    fb = polygons_bounds(forest_polys)  # (F, 4)
    # (T, F) bbox overlap of buffered tile boxes vs forest bounds
    overlap = ((fb[None, :, 2] > bx0[:, None]) & (fb[None, :, 0] < bx1[:, None]) &
               (fb[None, :, 3] > by0[:, None]) & (fb[None, :, 1] < by1[:, None]))
    any_overlap = overlap.any(axis=1)
    only_urban = ~any_overlap
    if not any_overlap.any():
        return only_forest, only_urban

    # Rasterized union of forest polygons over the tiled extent.
    minx, miny = float(bx0.min()), float(by0.min())
    maxx, maxy = float(bx1.max()), float(by1.max())
    res = coverage_resolution
    w = max(8, int(np.ceil((maxx - minx) / res)))
    h = max(8, int(np.ceil((maxy - miny) / res)))
    # cap memory at ~64M cells by coarsening
    while w * h > 64_000_000:
        res *= 2.0
        w = max(8, int(np.ceil((maxx - minx) / res)))
        h = max(8, int(np.ceil((maxy - miny) / res)))
    tr = Affine.from_origin(minx, maxy, (maxx - minx) / w, (maxy - miny) / h)
    mask = rasterize_polygons(forest_polys, tr, (h, w), dtype=np.uint8)
    # integral image -> per-tile-window full-coverage test in O(1) per tile
    integral = np.zeros((h + 1, w + 1), dtype=np.int64)
    np.cumsum(np.cumsum(mask, axis=0), axis=1, out=integral[1:, 1:])
    inv = tr.invert()
    c0, r1 = inv.apply(bx0, by0)   # note: miny -> bottom row
    c1, r0 = inv.apply(bx1, by1)
    # interior pixel window (fully inside the bbox)
    c0i = np.clip(np.ceil(c0).astype(int), 0, w)
    c1i = np.clip(np.floor(c1).astype(int), 0, w)
    r0i = np.clip(np.ceil(r0).astype(int), 0, h)
    r1i = np.clip(np.floor(r1).astype(int), 0, h)
    width = np.maximum(c1i - c0i, 0)
    height = np.maximum(r1i - r0i, 0)
    area = width * height
    covered = (integral[r1i, c1i] - integral[r0i, c1i]
               - integral[r1i, c0i] + integral[r0i, c0i])
    full = (area > 0) & (covered == area)
    # precise intersect: any forest pixel in the window
    some = covered > 0
    only_forest = any_overlap & full
    # bbox-overlap candidates that have no actual forest pixel -> urban
    only_urban = only_urban | (any_overlap & ~some)
    return only_forest, only_urban


def tile_single_file(data_path: str,
                     out_dir: str,
                     buffer: float = 0,
                     tile_width: float = 50,
                     tile_height: float = 50,
                     forest_polys: Optional[Sequence[np.ndarray]] = None,
                     logger=None) -> str:
    """Plan tiles for one raster and write ``<stem>.json`` tile metadata.

    Tile-id format and metadata schema match reference
    ``preprocessing.py:59,108-120`` exactly, so downstream stages (and any
    tooling built against the reference's intermediates) interoperate.
    """
    if not os.path.isfile(data_path):
        raise FileNotFoundError(f"File not found: {data_path}")
    os.makedirs(out_dir, exist_ok=True)
    src = GeoTiff(data_path)
    crs = src.crs
    tilename = Path(data_path).stem
    bounds = src.bounds
    transform = src.transform
    src.close()

    minxs, minys = tile_grid(bounds, tile_width, tile_height)
    only_forest, only_urban = compute_forest_flags(
        minxs, minys, tile_width, tile_height, buffer, forest_polys)

    # window transforms for all tiles, computed in batch
    bx0, by0 = minxs - buffer, minys - buffer
    bx1, by1 = minxs + tile_width + buffer, minys + tile_height + buffer
    inv = transform.invert()
    cols0, rows0 = inv.apply(bx0, by1)  # top-left pixel of buffered bbox
    col_off = np.floor(cols0 + 1e-9)
    row_off = np.floor(rows0 + 1e-9)
    ox, oy = transform.apply(col_off, row_off)

    metadata: Dict[str, Any] = {}
    a, b, _, d, e, _ = transform
    for i in range(len(minxs)):
        tile_id = (f"{tilename}_{int(minxs[i])}_{int(minys[i])}"
                   f"_{int(tile_width)}_{int(buffer)}_{crs}")
        metadata[tile_id] = {
            "crs": crs,
            "transform": [a, b, float(ox[i]), d, e, float(oy[i])],
            "bounds": [float(bx0[i]), float(by0[i]), float(bx1[i]), float(by1[i])],
            "only_forest": bool(only_forest[i]),
            "only_urban": bool(only_urban[i]),
        }

    out_file = os.path.join(out_dir, f"{tilename}.json")
    with open(out_file, "w") as fh:
        fh.write(json.dumps(metadata))
    return out_file


def tile_data(config: Dict[str, Any],
              image_paths: Sequence[str],
              forest_outline: Optional[str] = None) -> List[str]:
    """Tile all images, honoring the tiling recovery manifest.

    Multi-file entry point (reference ``preprocessing.py:125-224``): files fan out
    over a thread pool (planning is metadata-only but bounds/header reads are
    I/O-bound at county scale); the recovery manifest is saved from the main
    thread as results land.  Multi-host sharding of the *file list* happens
    one level up in ``parallel.partition_files``.
    """
    logger = config.get("logger")
    tiles_dir = config["tiles_path"]
    buffer = config["buffer"]
    tile_w, tile_h = config["tile_width"], config["tile_height"]

    forest_polys = None
    if forest_outline:
        forest_polys = load_outline_polygons(forest_outline)
        if logger:
            logger.info(f"Loaded {len(forest_polys)} forest outline polygons")

    processed = load_recovery_data(tiles_dir, buffer, tile_w, tile_h)
    out_files: List[Optional[str]] = [None] * len(image_paths)
    done: List[str] = []
    todo: List[Tuple[int, str]] = []
    for i, path in enumerate(image_paths):
        stem = Path(path).stem
        meta_path = os.path.join(tiles_dir, f"{stem}.json")
        if path in processed and os.path.exists(meta_path):
            out_files[i] = meta_path
            done.append(path)
        else:
            todo.append((i, path))

    from concurrent.futures import ThreadPoolExecutor, as_completed
    workers = max(min(int(config.get("num_workers") or 8), len(todo) or 1), 1)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        futs = {ex.submit(tile_single_file, path, tiles_dir, buffer, tile_w,
                          tile_h, forest_polys, logger): (i, path)
                for i, path in todo}
        for k, fut in enumerate(as_completed(futs)):
            i, path = futs[fut]
            try:
                out_files[i] = fut.result()
                done.append(path)
            except (OSError, ValueError) as exc:  # keep county runs alive (ref preprocessing.py:189-193)
                if logger:
                    logger.error(f"Tiling failed for {path}: {exc}")
            if logger and len(todo) >= 20 and (k + 1) % max(1, len(todo) // 20) == 0:
                logger.info(f"Tiling progress: {k + 1}/{len(todo)}")
            save_recovery_data(tiles_dir, buffer, tile_w, tile_h,
                               sorted(set(processed) | set(done)))
    return [f for f in out_files if f is not None]


def load_outline_polygons(path: str) -> List[np.ndarray]:
    """Load outline/exclusion geometry as a flat list of exterior rings."""
    from treedetection_tpu_torch.vector import read_gpkg, read_shapefile
    from treedetection_tpu_torch.vector.geojson import read_geojson
    ext = os.path.splitext(path)[1].lower()
    if ext == ".shp":
        geoms, _ = read_shapefile(path)
    elif ext == ".gpkg":
        geoms, _, _ = read_gpkg(path)
    elif ext in (".geojson", ".json"):
        geoms, _ = read_geojson(path)
    else:
        raise ValueError(f"Unsupported outline format: {path}")
    rings: List[np.ndarray] = []
    for multi in geoms:
        for poly in multi:
            if poly:
                rings.append(np.asarray(poly[0], dtype=np.float64))
    return rings


# --- recovery (reference preprocessing.py:226-278) -------------------------

def _recovery_path(tiles_dir: str) -> str:
    return os.path.join(tiles_dir, "recovery.yaml")


def load_recovery_data(tiles_dir: str, buffer: float, tile_width: float,
                       tile_height: float) -> List[str]:
    """Return the list of already-tiled source files IF the stored tiling
    parameters match; otherwise reset (reference ``preprocessing.py:233-238``)."""
    path = _recovery_path(tiles_dir)
    if not os.path.exists(path):
        return []
    try:
        data = flatyaml.load(path) or {}
    except flatyaml.FlatYamlError:
        return []
    if (data.get("buffer") != buffer or data.get("tile_width") != tile_width
            or data.get("tile_height") != tile_height):
        return []
    out = []
    for f in data.get("processed_files", []):
        meta = os.path.join(tiles_dir, f"{Path(f).stem}.json")
        if os.path.exists(meta):
            out.append(f)
    return out


def save_recovery_data(tiles_dir: str, buffer: float, tile_width: float,
                       tile_height: float, processed_files: List[str]) -> None:
    os.makedirs(tiles_dir, exist_ok=True)
    flatyaml.dump({
        "buffer": buffer,
        "tile_width": tile_width,
        "tile_height": tile_height,
        "processed_files": list(processed_files),
    }, _recovery_path(tiles_dir))


def load_tile_metadata(meta_path: str) -> Dict[str, Dict[str, Any]]:
    with open(meta_path) as fh:
        return json.load(fh)
