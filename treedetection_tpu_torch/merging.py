"""Stage 1b — cross-image overlap strips for seam coverage.

For each image, find its right/down neighbor by affine origin and emit a
synthetic strip raster centered on the shared seam, so tiles re-predicted on
the strip cover crowns cut by image borders.  Contract parity with reference
``merging.py:10-119`` + ``helpers.py:984-1085``:

* neighbor = image whose origin is exactly one raster-width right (resp. one
  raster-height down), eps 1e-3 (reference ``helpers.py:1004-1017``)
* strip size = ``(tile_w + 2*buffer) * overlapping_tiles_w`` interpreted in
  PIXELS (the reference passes geo-unit tile sizes into a pixel window —
  reference ``merging.py:69-72`` + ``helpers.py:1062-1070``; we preserve that
  quirk because the postprocessing regex/bounds logic depends on the resulting
  extents), centered on the merged image
* filenames: ``{base}_{x1}_{y1}_{x2}_{y2}_{end}.tif`` for RGBI and
  ``{base}_{x1}{y1}{x2}{y2}_{end}.tif`` (concatenated digits) for nDSM
  (reference ``merging.py:65-67,94-96``)

Performance: the reference rasterio-merges BOTH full rasters into memory and
then center-crops.  Since the crop is a fixed centered window, we read only
the two sub-windows that intersect the strip — O(strip) I/O instead of
O(2 images).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from treedetection_tpu_torch.geo import Affine, GeoTiff, write_geotiff


def retrieve_neighbors(path: str, others: Sequence[str],
                       meta: Dict[str, Tuple[Affine, int, int]]
                       ) -> Tuple[Optional[str], Optional[str], Optional[str], Optional[str]]:
    """(left, right, up, down) neighbor filenames by affine origin.

    Matches reference ``helpers.py:984-1021`` including its use of the x pixel
    size for the vertical neighbor distance (square-pixel assumption).
    """
    transform, width, height = meta[path]
    x, y = transform.c, transform.f
    eps = 1e-3
    left = right = up = down = None
    for other in others:
        if other == path:
            continue
        ot, ow, oh = meta[other]
        if abs(ot.c - (x - width * ot.a)) < eps and abs(ot.f - y) < eps:
            left = other
        if abs(ot.c - (x + width * ot.a)) < eps and abs(ot.f - y) < eps:
            right = other
        if abs(ot.f - (y + height * ot.a)) < eps and abs(ot.c - x) < eps:
            up = other
        if abs(ot.f - (y - height * ot.a)) < eps and abs(ot.c - x) < eps:
            down = other
    return left, right, up, down


def _merged_name(f: str, neighbor_origin: Tuple[float, float],
                 own_origin: Tuple[float, float], rgbi: bool) -> str:
    base = os.path.basename(f).replace(".tif", "").split("_")[0]
    end = os.path.basename(f).replace(".tif", "").split("_")[-1]
    x1, y1 = round(own_origin[0]), round(own_origin[1])
    x2, y2 = round(neighbor_origin[0]), round(neighbor_origin[1])
    if rgbi:
        return f"{base}_{x1}_{y1}_{x2}_{y2}_{end}.tif"
    return f"{base}_{x1}{y1}{x2}{y2}_{end}.tif"


def _seam_strip(a_path: str, b_path: str, horizontal: bool,
                strip_px: int, out_path: str) -> None:
    """Extract the centered strip across the seam between a (left/top) and b."""
    a = GeoTiff(a_path)
    b = GeoTiff(b_path)
    nodata = a.nodata
    if nodata is None or abs(nodata) > 1e10:
        nodata = 0.0  # reference merge_images nodata fixup (helpers.py:1040-1043)

    if horizontal:
        merged_w = a.width + b.width
        merged_h = max(a.height, b.height)
        # centered window of width strip_px over the merged extent
        left_px = max(merged_w // 2 - strip_px // 2, 0)
        win_w, win_h = strip_px, merged_h
        # columns [left_px, left_px+strip_px) of the merged mosaic; a spans [0, a.width)
        parts = []
        a_c0, a_c1 = left_px, min(left_px + win_w, a.width)
        if a_c1 > a_c0:
            parts.append((a, a_c0, 0, a_c1 - a_c0, "a"))
        b_c0 = max(left_px - a.width, 0)
        b_c1 = left_px + win_w - a.width
        if b_c1 > b_c0:
            parts.append((b, b_c0, a_c1 - a_c0 if a_c1 > a_c0 else 0, b_c1 - b_c0, "b"))
        out = np.full((win_h, win_w, a.count), nodata, dtype=a.dtype)
        for src, c0, dest_c, w, _tag in parts:
            data = src.read((c0, 0, w, min(win_h, src.height)), fill_value=nodata)
            out[:data.shape[0], dest_c:dest_c + w] = data
        out_transform = a.transform.window_transform(left_px, 0)
    else:
        merged_h = a.height + b.height
        merged_w = max(a.width, b.width)
        top_px = max(merged_h // 2 - strip_px // 2, 0)
        win_w, win_h = merged_w, strip_px
        out = np.full((win_h, win_w, a.count), nodata, dtype=a.dtype)
        a_r0, a_r1 = top_px, min(top_px + win_h, a.height)
        if a_r1 > a_r0:
            data = a.read((0, a_r0, min(win_w, a.width), a_r1 - a_r0), fill_value=nodata)
            out[:a_r1 - a_r0, :data.shape[1]] = data
        b_r0 = max(top_px - a.height, 0)
        b_r1 = top_px + win_h - a.height
        if b_r1 > b_r0:
            dest_r = a_r1 - a_r0 if a_r1 > a_r0 else 0
            data = b.read((0, b_r0, min(win_w, b.width), b_r1 - b_r0), fill_value=nodata)
            out[dest_r:dest_r + (b_r1 - b_r0), :data.shape[1]] = data
        out_transform = a.transform.window_transform(0, top_px)

    write_geotiff(out_path, out, out_transform, crs=a.crs, nodata=a.nodata)
    a.close()
    b.close()


def merge_and_crop_images(config: Dict[str, Any],
                          images_paths: List[str],
                          height_paths: List[str]) -> None:
    """Generate seam strips for all right/down neighbor pairs; extends the two
    path lists in place with the synthetic rasters (reference
    ``merging.py:10-119`` contract)."""
    logger = config.get("logger")
    merged_directory = config["merged_path"]
    strip_w = int((config["tile_width"] + 2 * config["buffer"])
                  * config["overlapping_tiles_width"])
    strip_h = int((config["tile_height"] + 2 * config["buffer"])
                  * config["overlapping_tiles_height"])

    def process(paths: List[str], rgbi: bool) -> List[str]:
        meta: Dict[str, Tuple[Affine, int, int]] = {}
        for f in paths:
            try:
                g = GeoTiff(f)
                meta[f] = (g.transform, g.width, g.height)
                g.close()
            except (OSError, ValueError) as exc:
                if logger:
                    logger.error(f"Cannot read {f}: {exc}")
        created: List[str] = []
        valid = [f for f in meta]
        for f in valid:
            _, right, _, down = retrieve_neighbors(f, valid, meta)
            directory = os.path.dirname(f)
            result_directory = os.path.join(directory, merged_directory)
            own_origin = (meta[f][0].c, meta[f][0].f)
            for neighbor, horizontal, strip_px in ((right, True, strip_w),
                                                   (down, False, strip_h)):
                if neighbor is None:
                    continue
                os.makedirs(result_directory, exist_ok=True)
                n_origin = (meta[neighbor][0].c, meta[neighbor][0].f)
                out_name = _merged_name(f, n_origin, own_origin, rgbi)
                out_path = os.path.join(result_directory, out_name)
                if os.path.exists(out_path):
                    created.append(out_path)
                    continue
                try:
                    _seam_strip(f, neighbor, horizontal, strip_px, out_path)
                    created.append(out_path)
                except (OSError, ValueError) as exc:
                    if logger:
                        logger.error(f"Error merging {f} and {neighbor}: {exc}")
        return created

    images_paths.extend(process(images_paths, rgbi=True))
    height_paths.extend(process(height_paths, rgbi=False))


def merge_across_batches(config: Dict[str, Any],
                         batch_dirs: Sequence[str],
                         rgbi: bool = True,
                         out_subdir: Optional[str] = None) -> List[str]:
    """Seam strips ACROSS delivery-batch directories (county-boundary seams).

    Standalone counterpart of reference
    ``supplementary/inference_get_neigboring.py:18-143``: collect the rasters
    of multiple directories into one neighbor search so strips spanning batch
    boundaries get generated too.  Strips land in each left/top image's own
    directory's merged folder (or ``out_subdir``).
    """
    import glob as _glob
    logger = config.get("logger")
    all_paths: List[str] = []
    for d in batch_dirs:
        all_paths.extend(sorted(_glob.glob(os.path.join(d, "*.tif"))))
    merged_dir = out_subdir or config.get("merged_path", "merged")
    sub_config = dict(config)
    sub_config["merged_path"] = merged_dir
    paths = list(all_paths)
    # reuse the pairwise machinery with the combined list
    before = set(paths)
    merge_and_crop_images(sub_config, paths if rgbi else [],
                          [] if rgbi else paths)
    created = [p for p in paths if p not in before]
    if logger:
        logger.info(f"Cross-batch merging created {len(created)} strips "
                    f"from {len(all_paths)} rasters in {len(batch_dirs)} batches")
    return created
