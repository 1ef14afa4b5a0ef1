"""Stage 2b — stitching per-tile predictions into one crown layer per image.

Replaces the reference stitcher (reference ``helpers.py:419-600``): for each
image, read all ``Prediction_<tile_id>.json`` files, simplify crowns
(tolerance, reference ``helpers.py:463-464``), and keep only crowns fully
within the tile's shrunk bounding box (``box_filter`` with shift, reference
``helpers.py:466-468,280-303``); concat across tiles into a per-image GPKG.

The within-box test is a pure interval check on each crown's
vertex extrema — done vectorized over the whole tile's crowns at once; no
GEOS sjoin needed (the boxes are axis-aligned by construction).

Prediction files in the detectree2 format (an RLE ``segmentation`` instead
of ``polygon_coords``) are decoded and traced through ``compat``.
"""

from __future__ import annotations

import glob
import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from treedetection_tpu_torch.recoveries import (
    load_stitching_recovery_data, save_stitching_recovery_data)
from treedetection_tpu_torch.vector import simplify_polygon, write_gpkg
from treedetection_tpu_torch.vector.polygon import ensure_open


def filename_geoinfo(tile_id: str) -> Tuple[int, int, int, int, int]:
    """Parse ``{stem}_{minx}_{miny}_{width}_{buffer}_{epsg}`` (the tile-id
    format shared with the reference, ``preprocessing.py:59``)."""
    base = os.path.basename(tile_id)
    for ext in (".geojson", ".json", ".gpkg"):
        base = base.replace(ext, "")
    parts = base.split("_")
    minx, miny, width, buffer, crs = (int(p) for p in parts[-5:])
    return minx, miny, width, buffer, crs


def shrunk_tile_box(tile_id: str, shift: float = 0.0
                    ) -> Tuple[float, float, float, float]:
    """The buffered tile bbox shrunk inward by ``shift`` meters (reference
    ``box_make``, ``helpers.py:280-303``)."""
    minx, miny, width, buffer, _ = filename_geoinfo(tile_id)
    return (minx - buffer + shift, miny - buffer + shift,
            minx + width + buffer - shift, miny + width + buffer - shift)


def stitch_rings(tile_id: str, rings: List[np.ndarray], scores: List[float],
                 simplify_tolerance: float, shift: float = 1.0
                 ) -> Tuple[List[np.ndarray], List[float]]:
    """The per-tile stitch transform on in-memory rings: simplify each crown
    and keep only those fully within the tile's shrunk box.  Shared by the
    file-based path (``stitch_tile_file``) and the Predictor's eager stitch
    sink so both produce identical crowns."""
    bminx, bminy, bmaxx, bmaxy = shrunk_tile_box(tile_id, shift)
    crowns: List[np.ndarray] = []
    kept_scores: List[float] = []
    for ring, score in zip(rings, scores):
        if len(ring) < 4:
            continue
        if simplify_tolerance > 0:
            ring = simplify_polygon(ring, simplify_tolerance)
        crowns.append(ring)
        kept_scores.append(float(score))
    if not crowns:
        return [], []

    # vectorized within-box filter over all crowns of the tile
    keep = []
    for ring in crowns:
        r = ensure_open(ring)
        keep.append(r[:, 0].min() >= bminx and r[:, 0].max() <= bmaxx and
                    r[:, 1].min() >= bminy and r[:, 1].max() <= bmaxy)
    kept = [c for c, k in zip(crowns, keep) if k]
    kept_scores = [s for s, k in zip(kept_scores, keep) if k]
    return kept, kept_scores


def stitch_tile_file(pred_file: str, simplify_tolerance: float,
                     shift: float = 1.0
                     ) -> Tuple[List[np.ndarray], List[float]]:
    """One prediction JSON -> (kept crowns, scores)."""
    with open(pred_file) as fh:
        data = json.load(fh)
    tile_id = Path(pred_file).stem.replace("Prediction_", "")

    rings: List[np.ndarray] = []
    scores: List[float] = []
    for crown in data:
        coords = crown.get("polygon_coords")
        if coords:
            ring = np.asarray(coords[0], dtype=np.float64).reshape(-1, 2)
        elif "segmentation" in crown:
            # RLE fallback for detectree2-format prediction files
            # (reference helpers.py:443-457)
            from treedetection_tpu_torch.compat import (polygon_from_mask,
                                                        rle_decode)
            flat = polygon_from_mask(rle_decode(crown["segmentation"]))
            if not flat:
                continue
            ring = np.asarray(flat, dtype=np.float64).reshape(-1, 2)
        else:
            continue
        rings.append(ring)
        scores.append(float(crown.get("score", 0.0)))
    return stitch_rings(tile_id, rings, scores, simplify_tolerance, shift)


def stitch_image(pred_dir: str, out_gpkg: str, simplify_tolerance: float = 0.2,
                 shift: float = 1.0, srs_id: int = 25832,
                 logger=None) -> int:
    """Stitch all tile predictions of one image folder -> GPKG; returns crown
    count (reference ``process_folder_sync``, ``helpers.py:524-554``)."""
    files = sorted(glob.glob(os.path.join(pred_dir, "Prediction_*.json")))
    all_crowns: List[np.ndarray] = []
    all_scores: List[float] = []
    for f in files:
        try:
            crowns, scores = stitch_tile_file(f, simplify_tolerance, shift)
            all_crowns.extend(crowns)
            all_scores.extend(scores)
        except (json.JSONDecodeError, ValueError, OSError) as exc:
            if logger:
                logger.warning(f"Error processing file {f}: {exc}")
    try:
        srs_id = filename_geoinfo(Path(files[0]).stem)[4] if files else srs_id
    except (ValueError, IndexError):
        pass
    write_gpkg(out_gpkg, all_crowns,
               [{"Confidence_score": s} for s in all_scores], srs_id=srs_id)
    return len(all_crowns)


def stitch_image_cached(tiles: Dict[str, Tuple[List[np.ndarray], List[float]]],
                        out_gpkg: str, srs_id: int = 25832) -> int:
    """Write a per-image GPKG from the Predictor's eager stitch sink — the
    per-tile simplify + shrunk-box transform already ran at flush time
    (overlapped with device compute).  Tiles are assembled in sorted
    ``Prediction_<tile_id>.json`` filename order so the crown order is
    identical to the file-based ``stitch_image``."""
    all_crowns: List[np.ndarray] = []
    all_scores: List[float] = []
    names = sorted(tiles.keys())
    for name in names:
        crowns, scores = tiles[name]
        all_crowns.extend(crowns)
        all_scores.extend(scores)
    try:
        if names:
            srs_id = filename_geoinfo(Path(names[0]).stem)[4]
    except (ValueError, IndexError):
        pass
    write_gpkg(out_gpkg, all_crowns,
               [{"Confidence_score": s} for s in all_scores], srs_id=srs_id)
    return len(all_crowns)


def _sink_covers_dir(tiles: Dict[str, Any], pred_dir: str) -> bool:
    """The eager sink is only trusted when its tile set matches the
    ``Prediction_*.json`` files actually on disk — stale JSONs from a prior
    run (changed tiling parameters, partial reruns) would make the cached
    GPKG silently differ from the file-based glob."""
    try:
        on_disk = {f for f in os.listdir(pred_dir)
                   if f.startswith("Prediction_") and f.endswith(".json")}
    except OSError:
        return False
    return on_disk == set(tiles.keys())


def process_and_stitch_predictions(config: Dict[str, Any],
                                   prediction_root: str,
                                   image_names: List[str],
                                   suffix: str = "") -> List[str]:
    """Stitch every image folder under ``prediction_root`` with resume
    (reference ``helpers.py:556-600``).  Returns the per-image GPKG paths.

    Images whose tile predictions were fully produced this run consume the
    Predictor's in-memory stitch sink (no JSON re-parse, the per-tile
    transform already overlapped device compute); everything else — resumed
    runs, foreign prediction folders — takes the file-based path."""
    logger = config.get("logger")
    tolerance = config.get("simplify_tolerance", 0.2)
    done = set(load_stitching_recovery_data(prediction_root))
    outputs: List[str] = []
    completed = list(done)
    stitch_cache = config.get("_stitch_cache") or {}

    todo: List[Tuple[str, str, str]] = []
    cached: List[Tuple[str, str, str, Dict]] = []
    for name in image_names:
        stem = Path(name).stem
        pred_dir = os.path.join(prediction_root, stem)
        out_gpkg = os.path.join(prediction_root, f"{stem}{suffix}.gpkg")
        outputs.append(out_gpkg)
        if stem in done and os.path.exists(out_gpkg):
            continue
        entry = stitch_cache.pop(pred_dir, None)
        if entry is not None and entry.get("tolerance") == tolerance \
                and _sink_covers_dir(entry["tiles"], pred_dir):
            cached.append((stem, pred_dir, out_gpkg, entry["tiles"]))
            continue
        if not os.path.isdir(pred_dir):
            if logger:
                logger.warning(f"No predictions folder for {name}")
            continue
        todo.append((stem, pred_dir, out_gpkg))

    for i, (stem, pred_dir, out_gpkg, tiles) in enumerate(cached):
        try:
            n = stitch_image_cached(tiles, out_gpkg)
        except (OSError, ValueError, KeyError, TypeError) as exc:
            # the Prediction_*.json files are on disk — re-stitch from them
            # instead of losing the image this run
            if logger:
                logger.error(f"Stitching (cached) failed for {stem}: {exc}; "
                             f"falling back to file-based stitching")
            todo.append((stem, pred_dir, out_gpkg))
            continue
        completed.append(stem)
        save_stitching_recovery_data(prediction_root, completed)
        if logger:
            logger.info(f"Stitched {n} crowns for {stem} "
                        f"({i + 1}/{len(cached)}, eager)")

    # file-level thread pool (reference used max_workers=50,
    # ``helpers.py:556-580``); each image writes its own GPKG so the only
    # shared state is the recovery manifest, saved from the main thread.
    from concurrent.futures import ThreadPoolExecutor, as_completed
    workers = max(min(int(config.get("num_workers") or 8), len(todo) or 1), 1)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        futs = {ex.submit(stitch_image, pred_dir, out_gpkg, tolerance,
                          logger=logger): stem
                for stem, pred_dir, out_gpkg in todo}
        for i, fut in enumerate(as_completed(futs)):
            stem = futs[fut]
            try:
                n = fut.result()
            except (OSError, ValueError, KeyError, TypeError) as exc:
                # keep the batch alive (reference per-item try/except,
                # ``helpers.py:371-377``): one bad image folder or a full
                # disk must not lose the manifest for completed stems
                if logger:
                    logger.error(f"Stitching failed for {stem}: {exc}")
                continue
            completed.append(stem)
            save_stitching_recovery_data(prediction_root, completed)
            if logger:
                logger.info(f"Stitched {n} crowns for {stem} "
                            f"({i + 1}/{len(todo)})")
    return outputs
