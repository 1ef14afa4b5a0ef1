"""The synthetic orthophoto sheet with its nDSM, made from a seed.

A frozen copy of the program's ``utils.synthetic.write_synthetic_sheet``
(same draws in the same order, so the same seed gives the same pixels), as
arrays rather than files: a 20 cm RGBI sheet of crown-like discs (2-8 m
radius: darker red and blue, raised NIR) on a lighter ground, and the same
discs as 5-25 m domes on a 1 m nDSM.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def make_sheet(side_px: int, n_discs: int,
               seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """-> (RGBI uint8 (side, side, 4), nDSM float32 (side/5, side/5))."""
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
        top = rng.uniform(5.0, 25.0)
        my0, my1 = max(int(cy / 5 - rad_m), 0), min(int(cy / 5 + rad_m) + 1, hm)
        mx0, mx1 = max(int(cx / 5 - rad_m), 0), min(int(cx / 5 + rad_m) + 1, hm)
        myy, mxx = np.mgrid[my0:my1, mx0:mx1]
        md2 = ((myy + 0.5 - cy / 5) ** 2 + (mxx + 0.5 - cx / 5) ** 2) / rad_m ** 2
        dome = np.where(md2 < 1.0, top * (1.0 - 0.5 * md2), 0.0)
        ndsm[my0:my1, mx0:mx1] = np.maximum(ndsm[my0:my1, mx0:mx1], dome)
    return np.clip(img, 0, 255).astype(np.uint8), ndsm

