"""A synthetic orthophoto sheet with its nDSM, made from a seed.

The reference's 1 km^2 sample is an nDSM with a stripped RGBI twin, so the
port's bench and ``chip_smoke.py``'s pipeline phases make their input here:
a 20 cm RGBI sheet of crown-like discs on a lighter ground, and the same
discs as domes on a 1 m nDSM, both written as GeoTIFFs in EPSG:25832.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

SHEET_ORIGIN = (412000.0, 5318000.0)          # top-left corner, UTM32N-ish
SHEET_PX = 5000                               # 1 km at 0.2 m: 400 tiles of 50 m
DISCS_PER_KM2 = 7000


def write_synthetic_sheet(rgb_path: Path, ndsm_path: Path, side_px: int,
                          origin, n_discs: int, seed: int) -> None:
    """A square RGBI sheet at 0.2 m with crown-like discs (2-8 m radius:
    darker red/blue, raised NIR so that the NDVI gates pass them) on a
    lighter ground, and its 1 m nDSM with the same discs standing 5-25 m
    high.  Discs are drawn in local windows."""
    from treedetection_tpu_torch.geo import Affine, write_geotiff
    rng = np.random.default_rng(seed)
    h = w = side_px
    img = rng.standard_normal((h, w, 4), dtype=np.float32)
    img *= np.array([12, 12, 12, 10], dtype=np.float32)
    img += np.array([150, 160, 120, 110], dtype=np.float32)
    hm = side_px // 5
    ndsm = np.zeros((hm, hm), dtype=np.float32)
    for _ in range(n_discs):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        rad_m = rng.uniform(2.0, 8.0)
        rad = rad_m / 0.2
        y0, y1 = max(int(cy - rad), 0), min(int(cy + rad) + 1, h)
        x0, x1 = max(int(cx - rad), 0), min(int(cx + rad) + 1, w)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        d2 = ((yy - cy) ** 2 + (xx - cx) ** 2) / rad ** 2
        inside = d2 < 1.0
        shade = (0.55 + 0.3 * d2[inside]).astype(np.float32)
        win = img[y0:y1, x0:x1]
        win[inside, 0] *= shade * 0.6
        win[inside, 1] *= shade * 0.85
        win[inside, 2] *= shade * 0.6
        win[inside, 3] = np.minimum(win[inside, 3] * 1.8, 255)
        # the same disc on the 1 m grid, as a dome of 5-25 m
        top = rng.uniform(5.0, 25.0)
        my0, my1 = max(int(cy / 5 - rad_m), 0), min(int(cy / 5 + rad_m) + 1, hm)
        mx0, mx1 = max(int(cx / 5 - rad_m), 0), min(int(cx / 5 + rad_m) + 1, hm)
        myy, mxx = np.mgrid[my0:my1, mx0:mx1]
        md2 = ((myy + 0.5 - cy / 5) ** 2 + (mxx + 0.5 - cx / 5) ** 2) / rad_m ** 2
        dome = np.where(md2 < 1.0, top * (1.0 - 0.5 * md2), 0.0)
        ndsm[my0:my1, mx0:mx1] = np.maximum(ndsm[my0:my1, mx0:mx1], dome)
    rgb_path.parent.mkdir(parents=True, exist_ok=True)
    ndsm_path.parent.mkdir(parents=True, exist_ok=True)
    write_geotiff(str(rgb_path), np.clip(img, 0, 255).astype(np.uint8),
                  Affine.from_origin(origin[0], origin[1], 0.2, 0.2),
                  crs=25832, compress="none")
    write_geotiff(str(ndsm_path), ndsm,
                  Affine.from_origin(origin[0], origin[1], 1.0, 1.0),
                  crs=25832, nodata=-9999.0)
