"""Concrete mask generators for :func:`autolabel.boxes.autolabel_image`
(counterpart of ``treedetection_tpu/autolabel/sam.py``).

The reference prompts SamGeo (SAM ``vit_h`` / SAM-HQ) with annotation boxes
(reference ``supplementary/segment_annotations.py:291-384``).  Two adapters
implement the ``mask_generator(image_hwc, boxes_px) -> (N, H, W) bool``
interface the autolabeler consumes:

* :class:`SamMaskGenerator` — wraps a ``segment_anything``-style torch
  predictor when that package + checkpoint are available on the host
  (import-gated: the SAM weights are an external asset, exactly as in the
  reference where samgeo was a supplementary-only dependency).
* :func:`region_grow_mask_generator` — first-party, dependency-free fallback:
  per box, threshold the interior against the box's border statistics and
  keep the connected component covering the box center.  Runnable everywhere
  (tests, demo autolabeling on synthetic/real rasters) so the autolabel flow
  is exercisable end-to-end without SAM.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from treedetection_tpu_torch.autolabel.voronoi import height_seeds, read_height
from treedetection_tpu_torch.native import trace_contours
from treedetection_tpu_torch.vector import write_gpkg
from treedetection_tpu_torch.vector.polygon import polygon_area


class SamMaskGenerator:
    """Box-prompted SAM adapter (``segment_anything`` torch implementation).

    Usage::

        gen = SamMaskGenerator("/path/sam_vit_h.pth", model_type="vit_h")
        crowns, flags = autolabel_image(image, boxes, gen)

    The heavy image embedding runs once per image (``set_image``), then each
    box decodes a mask — the same batching structure the reference's SamGeo
    path uses (``segment_annotations.py:331-352``).
    """

    def __init__(self, checkpoint: str, model_type: str = "vit_h",
                 device: str = "cuda", multimask_output: bool = False):
        try:
            from segment_anything import SamPredictor, sam_model_registry
        except ImportError as exc:  # pragma: no cover - external dependency
            raise ImportError(
                "SamMaskGenerator needs the 'segment_anything' package and a "
                "SAM checkpoint; install them or use "
                "region_grow_mask_generator / any callable with the "
                "mask_generator(image, boxes) -> (N, H, W) interface"
            ) from exc
        sam = sam_model_registry[model_type](checkpoint=checkpoint)
        sam.to(device)
        self._predictor = SamPredictor(sam)
        self._multimask = multimask_output

    def __call__(self, image: np.ndarray, boxes: np.ndarray) -> np.ndarray:
        import torch
        img = np.ascontiguousarray(image[:, :, :3].astype(np.uint8))
        self._predictor.set_image(img)
        t_boxes = torch.as_tensor(np.asarray(boxes, dtype=np.float32),
                                  device=self._predictor.device)
        t_boxes = self._predictor.transform.apply_boxes_torch(
            t_boxes, img.shape[:2])
        masks, scores, _ = self._predictor.predict_torch(
            point_coords=None, point_labels=None, boxes=t_boxes,
            multimask_output=self._multimask)
        if self._multimask:
            # take each box's highest-predicted-IoU hypothesis; index 0 is
            # SAM's smallest "subpart" mask, not the best one
            best = scores.argmax(dim=1)
            masks = masks[torch.arange(masks.shape[0]), best]
            return masks.cpu().numpy().astype(bool)
        return masks[:, 0].cpu().numpy().astype(bool)


def region_grow_mask_generator(image: np.ndarray, boxes: np.ndarray,
                               channel: Optional[int] = None,
                               margin: float = 0.15) -> np.ndarray:
    """First-party box-prompted segmenter (no external model).

    Per box: score each pixel by the chosen channel (default: greenness
    ``G - (R+B)/2`` for RGB input, the raw band for single-channel rasters
    such as an nDSM), threshold at the midpoint between the box-border and
    box-center statistics, then keep the connected component containing the
    center.  Crude next to SAM but shape-aware, deterministic, and good
    enough to exercise the full autolabel -> clean -> train loop.
    """
    img = np.asarray(image)
    if img.ndim == 3 and img.shape[2] >= 3 and channel is None:
        score = img[:, :, 1].astype(np.float32) - \
            (img[:, :, 0].astype(np.float32) + img[:, :, 2].astype(np.float32)) / 2
    else:
        c = channel or 0
        score = (img[:, :, c] if img.ndim == 3 else img).astype(np.float32)
    h, w = score.shape
    out = np.zeros((len(boxes), h, w), dtype=bool)
    for k, (x0, y0, x1, y1) in enumerate(np.asarray(boxes, dtype=np.float64)):
        ix0, iy0 = max(int(np.floor(x0)), 0), max(int(np.floor(y0)), 0)
        ix1, iy1 = min(int(np.ceil(x1)), w), min(int(np.ceil(y1)), h)
        if ix1 - ix0 < 2 or iy1 - iy0 < 2:
            continue
        sub = score[iy0:iy1, ix0:ix1]
        my = int((iy1 - iy0) * margin)
        mx = int((ix1 - ix0) * margin)
        core = sub[my:(iy1 - iy0) - my or None, mx:(ix1 - ix0) - mx or None]
        border = np.concatenate([sub[0], sub[-1], sub[:, 0], sub[:, -1]])
        thr = (float(np.median(core)) + float(np.median(border))) / 2.0
        mask = sub >= thr
        comp = _component_at(mask, ((iy1 - iy0) // 2, (ix1 - ix0) // 2))
        if comp is None:  # center below threshold: fall back to the threshold mask
            comp = mask
        out[k, iy0:iy1, ix0:ix1] = comp
    return out


def _component_at(mask: np.ndarray, seed) -> Optional[np.ndarray]:
    """4-connected component of ``mask`` containing ``seed`` (BFS, numpy
    frontier expansion)."""
    if not mask[seed]:
        return None
    comp = np.zeros_like(mask)
    comp[seed] = True
    frontier = comp.copy()
    while frontier.any():
        grow = np.zeros_like(mask)
        grow[:-1] |= frontier[1:]
        grow[1:] |= frontier[:-1]
        grow[:, :-1] |= frontier[:, 1:]
        grow[:, 1:] |= frontier[:, :-1]
        frontier = grow & mask & ~comp
        comp |= frontier
    return comp


def generate_region_grow_labels(height_path: str, out_gpkg: str,
                                min_seed_height: float = 3.0,
                                sigma: float = 0.5, window: int = 7,
                                box_radius_cap: float = 8.0,
                                min_mask_pixels: int = 4,
                                logger=None, device="cuda") -> int:
    """nDSM GeoTIFF -> crown GPKG via box-prompted region growth.

    An INDEPENDENT label generator next to ``voronoi.generate_voronoi_labels``
    (used as the cross-generator quality check): the same local-maxima seeds,
    but each crown mask comes from :func:`region_grow_mask_generator` on a
    per-seed window (box side = distance to the nearest other seed, capped),
    traced to a polygon.  Masks are grown bbox-locally so memory stays
    bounded on county-scale rasters.  The seeds are found on ``device``.
    """
    height, transform, crs = read_height(height_path)
    smooth, seed_rc = height_seeds(height, sigma, window, min_seed_height,
                                   device)
    if len(seed_rc) == 0:
        write_gpkg(out_gpkg, [], [], srs_id=crs)
        return 0

    from scipy.spatial import cKDTree
    tree = cKDTree(seed_rc)
    # box half-side per seed: half the gap to the nearest other seed (px)
    d, _ = tree.query(seed_rc, k=min(2, len(seed_rc)))
    radii = (np.clip(d[:, 1] / 2.0, 1.0, box_radius_cap)
             if d.ndim == 2 else np.full(len(seed_rc), box_radius_cap))

    h, w = height.shape
    crowns, props = [], []
    for (sr, sc), r in zip(seed_rc, radii):
        ir = int(np.ceil(r))
        y0, y1 = max(sr - ir, 0), min(sr + ir + 1, h)
        x0, x1 = max(sc - ir, 0), min(sc + ir + 1, w)
        if y1 - y0 < 3 or x1 - x0 < 3:
            continue
        sub = height[y0:y1, x0:x1]
        local_box = np.array([[0.0, 0.0, float(x1 - x0), float(y1 - y0)]])
        mask = region_grow_mask_generator(sub, local_box)[0]
        if mask.sum() < min_mask_pixels:
            continue
        rings = trace_contours(mask.astype(np.uint8), include_holes=False)
        if not rings:
            continue
        ring = max(rings, key=lambda q: abs(polygon_area(q.astype(np.float64))))
        pts = ring.astype(np.float64)
        gx, gy = transform.apply(pts[:, 0] + x0 + 0.5, pts[:, 1] + y0 + 0.5)
        crowns.append(np.stack([gx, gy], axis=1))
        props.append({"Confidence_score": 1.0,
                      "TreeHeight": float(smooth[sr, sc])})
    write_gpkg(out_gpkg, crowns, props, srs_id=crs)
    if logger:
        logger.info(f"region-grow autolabels: {len(crowns)} crowns -> {out_gpkg}")
    return len(crowns)
