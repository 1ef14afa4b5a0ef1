"""Cambridge-style per-image autolabel + evaluation flow (counterpart of
``treedetection_tpu/autolabel/cambridge.py``).

Reference counterpart: ``supplementary/sement_annotations_cambridge.py`` and
``supplementary/segment_evaluation_cambridge.py`` — the detectree2 benchmark
variant where bounding boxes are generated FROM the polygon annotations
(``segment_evaluation_cambridge.py:25-38``), a box-prompted segmenter turns
them into crowns, and each image is scored against its own annotations.

Flow per image: raster + annotation GPKG -> annotation bboxes (geo) -> pixel
boxes -> ``autolabel_image`` (any mask generator, e.g.
``autolabel.sam.SamMaskGenerator`` or the first-party
``region_grow_mask_generator``) -> geo crowns GPKG + P/R/F1/IoU row.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from treedetection_tpu_torch.autolabel.boxes import autolabel_image
from treedetection_tpu_torch.autolabel.sam import region_grow_mask_generator
from treedetection_tpu_torch.eval.scores import evaluate
from treedetection_tpu_torch.geo import GeoTiff
from treedetection_tpu_torch.vector import read_gpkg, write_gpkg


def annotation_pixel_boxes(geoms: Sequence[np.ndarray], inv_transform
                           ) -> np.ndarray:
    """Geo annotation polygons -> (N, 4) pixel-space prompt boxes
    (reference ``generate_bounding_boxes``,
    ``segment_evaluation_cambridge.py:25-38``)."""
    boxes = []
    for ring in geoms:
        cols, rows = inv_transform.apply(ring[:, 0], ring[:, 1])
        boxes.append([np.min(cols), np.min(rows), np.max(cols), np.max(rows)])
    return np.asarray(boxes, dtype=np.float64).reshape(-1, 4)


def autolabel_and_evaluate(image_path: str, annotations_path: str,
                           mask_generator: Optional[Callable] = None,
                           out_gpkg: Optional[str] = None,
                           box_threshold: float = 0.5,
                           iou_threshold: float = 0.5) -> Dict[str, Any]:
    """One image: autolabel crowns from annotation-box prompts, optionally
    write them, and score them against the annotations themselves.

    Returns ``{image, n_annotations, n_crowns, precision, recall, f1,
    mean_iou, flags}`` (reference per-image eval,
    ``segment_evaluation_cambridge.py`` main loop)."""
    if mask_generator is None:
        mask_generator = region_grow_mask_generator

    src = GeoTiff(image_path)
    image = src.read()
    geoms, props, srs = read_gpkg(annotations_path)
    rings = [np.asarray(g[0][0], dtype=np.float64) for g in geoms if g and g[0]]
    if not rings:
        src.close()
        return {"image": image_path, "n_annotations": 0, "n_crowns": 0,
                "precision": 0.0, "recall": 0.0, "f1": 0.0, "mean_iou": 0.0,
                "flags": {}}
    boxes_px = annotation_pixel_boxes(rings, src.transform.invert())
    crowns, flags = autolabel_image(image, boxes_px, mask_generator,
                                    transform=src.transform,
                                    box_threshold=box_threshold)
    src.close()

    if out_gpkg:
        write_gpkg(out_gpkg, crowns,
                   [{"Confidence_score": 1.0, "flag": f} for f in flags],
                   srs_id=srs)

    res = evaluate(crowns, [1.0] * len(crowns), rings,
                   iou_threshold=iou_threshold, confidence_threshold=0.0)
    counts: Dict[str, int] = {}
    for f in flags:
        counts[f] = counts.get(f, 0) + 1
    return {"image": image_path, "n_annotations": len(rings),
            "n_crowns": len(crowns), "precision": res["precision"],
            "recall": res["recall"], "f1": res["f1"],
            "mean_iou": res["mean_iou"], "flags": counts}


def process_directory(image_dir: str, annotation_dir: str, out_dir: str,
                      mask_generator: Optional[Callable] = None,
                      logger=None, **kw) -> List[Dict[str, Any]]:
    """Autolabel + evaluate every (image, annotation) stem pair — the
    directory loop of the Cambridge flow."""
    os.makedirs(out_dir, exist_ok=True)
    ann_by_stem = {Path(p).stem: os.path.join(annotation_dir, p)
                   for p in os.listdir(annotation_dir) if p.endswith(".gpkg")}
    rows: List[Dict[str, Any]] = []
    for name in sorted(os.listdir(image_dir)):
        if not name.endswith(".tif"):
            continue
        stem = Path(name).stem
        ann = ann_by_stem.get(stem)
        if ann is None:
            if logger:
                logger.warning(f"No annotations for {name}")
            continue
        row = autolabel_and_evaluate(
            os.path.join(image_dir, name), ann,
            mask_generator=mask_generator,
            out_gpkg=os.path.join(out_dir, f"{stem}_autolabel.gpkg"), **kw)
        rows.append(row)
        if logger:
            logger.info(f"{stem}: f1={row['f1']:.3f} "
                        f"iou={row['mean_iou']:.3f} ({row['n_crowns']} crowns)")
    return rows
