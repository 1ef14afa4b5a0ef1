"""Stage 1 — tiling: metadata-only tile planning over raster bounds.

Counterpart of ``treedetection_tpu/preprocessing.py``: walk the raster bounds
in ``tile_width`` x ``tile_height`` geo-unit steps and write ONE JSON per
image mapping ``tile_id -> {crs, transform, bounds, only_forest,
only_urban}``.  The tile-id format and the metadata schema are byte-identical
to the JAX package's.  No pixel data is written — the Predictor re-crops from
the source raster.

The forest/urban flags need the vector stack, which arrives with the
two-model slice; until then :func:`tile_single_file` raises when given
``forest_polys`` and writes both flags as False.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from treedetection_tpu_torch.geo import GeoTiff


def tile_grid(bounds: Tuple[float, float, float, float],
              tile_width: float, tile_height: float
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(minx, miny) arrays of the tile grid over raster bounds."""
    xs = np.arange(bounds[0], bounds[2], tile_width)
    ys = np.arange(bounds[1], bounds[3], tile_height)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    return gx.ravel(), gy.ravel()


def tile_single_file(data_path: str,
                     out_dir: str,
                     buffer: float = 0,
                     tile_width: float = 50,
                     tile_height: float = 50,
                     forest_polys: Optional[Sequence[np.ndarray]] = None,
                     logger=None) -> str:
    """Plan tiles for one raster and write ``<stem>.json`` tile metadata."""
    if forest_polys:
        raise NotImplementedError(
            "forest/urban tile flags need the vector stack, which the port "
            "does not have yet")
    if not os.path.isfile(data_path):
        raise FileNotFoundError(f"File not found: {data_path}")
    os.makedirs(out_dir, exist_ok=True)
    src = GeoTiff(data_path)
    try:
        crs = src.crs
        tilename = Path(data_path).stem
        minxs, minys = tile_grid(src.bounds, tile_width, tile_height)

        # window transforms for all tiles, computed in batch
        bx0, by0 = minxs - buffer, minys - buffer
        bx1, by1 = minxs + tile_width + buffer, minys + tile_height + buffer
        inv = src.transform.invert()
        cols0, rows0 = inv.apply(bx0, by1)  # top-left pixel of buffered bbox
        col_off = np.floor(cols0 + 1e-9)
        row_off = np.floor(rows0 + 1e-9)
        ox, oy = src.transform.apply(col_off, row_off)

        metadata: Dict[str, Any] = {}
        a, b, _, d, e, _ = src.transform
        for i in range(len(minxs)):
            tile_id = (f"{tilename}_{int(minxs[i])}_{int(minys[i])}"
                       f"_{int(tile_width)}_{int(buffer)}_{crs}")
            metadata[tile_id] = {
                "crs": crs,
                "transform": [a, b, float(ox[i]), d, e, float(oy[i])],
                "bounds": [float(bx0[i]), float(by0[i]), float(bx1[i]),
                           float(by1[i])],
                "only_forest": False,
                "only_urban": False,
            }
    finally:
        src.close()

    out_file = os.path.join(out_dir, f"{tilename}.json")
    with open(out_file, "w") as fh:
        fh.write(json.dumps(metadata))
    return out_file


def load_tile_metadata(meta_path: str) -> Dict[str, Dict[str, Any]]:
    with open(meta_path) as fh:
        return json.load(fh)
