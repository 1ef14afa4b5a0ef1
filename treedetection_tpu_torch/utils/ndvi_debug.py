"""NDVI debug visualization (counterpart of
``treedetection_tpu/utils/ndvi_debug.py``; the NDVI and the resample run on
the caller's ``device``).

Parity with the reference's debug NDVI exports (reference
``helpers.py:898-978``): write the computed NDVI raster as a GeoTIFF next to
the source and render a viridis PNG plot for eyeballing vegetation masks.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from treedetection_tpu_torch.config import select_device
from treedetection_tpu_torch.geo import GeoTiff, write_geotiff
from treedetection_tpu_torch.ops.image import ndvi_from_rgbi
from treedetection_tpu_torch.postprocessing import _downscale


def write_ndvi_debug(rgbi_path: str, out_dir: Optional[str] = None,
                     scaling_factor: float = 1.0,
                     plot: bool = True,
                     device="cuda") -> Tuple[str, Optional[str]]:
    """Compute NDVI for an RGBI GeoTIFF on ``device`` and write
    ``<stem>_ndvi.tif`` (+ ``<stem>_ndvi.png`` viridis plot).  Returns
    (tif_path, png_path)."""
    g = GeoTiff(rgbi_path)
    if g.count < 4:
        raise ValueError(f"{rgbi_path} has {g.count} bands; NDVI needs RGBI")
    arr = torch.from_numpy(g.read().astype(np.float32))
    ndvi = ndvi_from_rgbi(arr.to(select_device(device))).cpu().numpy()
    transform = g.transform
    if scaling_factor != 1.0:
        ndvi, transform = _downscale(ndvi, transform, scaling_factor, device)

    out_dir = out_dir or os.path.dirname(rgbi_path)
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(rgbi_path))[0]
    tif_path = os.path.join(out_dir, f"{stem}_ndvi.tif")
    write_geotiff(tif_path, ndvi.astype(np.float32), transform, crs=g.crs,
                  nodata=-9999.0)
    png_path = None
    if plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(8, 8))
        im = ax.imshow(ndvi, cmap="viridis", vmin=-1, vmax=1)
        fig.colorbar(im, ax=ax, shrink=0.8, label="NDVI")
        ax.set_title(stem)
        ax.axis("off")
        png_path = os.path.join(out_dir, f"{stem}_ndvi.png")
        fig.savefig(png_path, dpi=110, bbox_inches="tight")
        plt.close(fig)
    g.close()
    return tif_path, png_path
