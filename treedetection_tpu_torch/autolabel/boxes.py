"""Box-guided crown autolabeling: turn box annotations into crown polygons
using any prompt-driven mask generator (SAM-style).  Counterpart of
``treedetection_tpu/autolabel/boxes.py``.

Parity with the reference's SAM autolabeling (reference
``supplementary/segment_annotations.py``): the SAM model itself is an external
dependency; here it is injected as ``mask_generator(image_hwc, boxes_px) ->
(N, H, W) bool masks`` so the cleaning logic — the part the reference actually
implements — is first-party and testable:

* per annotation box, keep the generated crown with the best IoU against the
  box (reference ``clean_crowns``, ``segment_annotations.py:55-113``)
* fall back to clipping the crown to the box when the IoU is below
  ``box_threshold``; fall back to the raw box when nothing matched
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np

from treedetection_tpu_torch.native import trace_contours
from treedetection_tpu_torch.vector.polygon import (
    clip_polygon_box, polygon_area, polygon_bounds, polygon_iou)


def box_to_ring(box: Sequence[float]) -> np.ndarray:
    x0, y0, x1, y1 = box
    return np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], dtype=np.float64)


def clean_crowns(crowns: Sequence[np.ndarray],
                 boxes: Sequence[Sequence[float]],
                 box_threshold: float = 0.5
                 ) -> Tuple[List[np.ndarray], List[str]]:
    """Assign the best crown to each annotation box.

    Returns (one polygon per box, provenance flags: 'crown' | 'clipped' |
    'box').  Mirrors reference ``segment_annotations.py:55-113``: best-IoU
    crown per box; clip-to-box when only a weak match exists; box fallback.
    """
    # bbox prefilter: rasterized polygon_iou costs a grid per pair; only
    # crowns whose bbox overlaps the annotation box can have IoU > 0
    crown_bounds = [polygon_bounds(c) if len(c) >= 3 else None for c in crowns]
    out: List[np.ndarray] = []
    flags: List[str] = []
    for box in boxes:
        ring_box = box_to_ring(box)
        bx0, by0, bx1, by1 = box
        best_iou, best = 0.0, None
        for crown, cb in zip(crowns, crown_bounds):
            if cb is None or cb[0] >= bx1 or cb[2] <= bx0 \
                    or cb[1] >= by1 or cb[3] <= by0:
                continue
            iou = polygon_iou(crown, ring_box)
            if iou > best_iou:
                best_iou, best = iou, crown
        if best is None:
            out.append(ring_box)
            flags.append("box")
        elif best_iou >= box_threshold:
            out.append(np.asarray(best))
            flags.append("crown")
        else:
            clipped = clip_polygon_box(best, tuple(box))
            if polygon_area(clipped) > 0:
                out.append(clipped)
                flags.append("clipped")
            else:
                out.append(ring_box)
                flags.append("box")
    return out, flags


def masks_to_crowns(masks: np.ndarray, transform=None) -> List[np.ndarray]:
    """(N, H, W) binary masks -> largest-contour polygons (pixel or geo)."""
    crowns: List[np.ndarray] = []
    for m in masks:
        rings = trace_contours(m.astype(np.uint8), include_holes=False)
        if not rings:
            continue
        ring = max(rings, key=lambda r: polygon_area(r.astype(np.float64)))
        pts = ring.astype(np.float64)
        if transform is not None:
            gx, gy = transform.apply(pts[:, 0], pts[:, 1])
            pts = np.stack([gx, gy], axis=1)
        crowns.append(pts)
    return crowns


def autolabel_image(image: np.ndarray,
                    annotation_boxes: Sequence[Sequence[float]],
                    mask_generator: Callable[[np.ndarray, np.ndarray], np.ndarray],
                    transform=None,
                    box_threshold: float = 0.5
                    ) -> Tuple[List[np.ndarray], List[str]]:
    """Full per-image flow (reference ``process_image``,
    ``segment_annotations.py:291-384``): prompt the generator with the boxes,
    polygonize the masks, box-guided cleaning.  Boxes are pixel coords; when
    ``transform`` is given the returned crowns are geo polygons."""
    boxes_px = np.asarray(annotation_boxes, dtype=np.float32)
    masks = mask_generator(image, boxes_px)
    crowns = masks_to_crowns(np.asarray(masks), transform=None)
    cleaned, flags = clean_crowns(crowns, boxes_px.tolist(), box_threshold)
    if transform is not None:
        geo = []
        for ring in cleaned:
            gx, gy = transform.apply(ring[:, 0], ring[:, 1])
            geo.append(np.stack([gx, gy], axis=1))
        cleaned = geo
    return cleaned, flags
