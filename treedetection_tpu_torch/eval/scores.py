"""Crown-detection scoring: greedy one-to-one IoU matching and P/R/F1 grids.

Counterpart of ``treedetection_tpu/eval/scores.py``, host numpy over the
port's ``vector.polygon``; it gives the same matches, ties included.
Replaces reference ``supplementary/evaluation_compute_scores.py``:

* greedy 1-1 matching by IoU with a spatial pre-filter
  (reference ``:55-111``; the STRtree becomes a uniform-grid bbox index —
  tiles are axis-aligned so a grid beats an R-tree, SURVEY §2.3)
* P/R/F1 + mean IoU over IoU thresholds x confidence thresholds
  (reference ``:113-138``; default grids {0.3..0.9} x {0.3..0.9})
* annotation pre-filters Area > 1 m^2, TreeHeight > 3 m, MeanNDVI > 0.15
  (reference ``:232,272``)
* TP/FP/FN overlay plots (reference ``:141-205``)

IoU between crowns uses adaptive-resolution rasterization
(``vector.polygon.polygon_iou``) — bbox candidates first, exact-ish IoU only
on overlapping pairs.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from treedetection_tpu_torch.vector.polygon import (
    polygon_area, polygon_iou, polygon_iou_exact, polygons_bounds)

DEFAULT_IOU_THRESHOLDS = (0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)
DEFAULT_CONF_THRESHOLDS = (0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)


def filter_annotations(geoms: Sequence[np.ndarray],
                       props: Sequence[Dict[str, Any]],
                       min_area: float = 1.0, min_height: float = 3.0,
                       min_mean_ndvi: float = 0.15
                       ) -> Tuple[List[np.ndarray], List[Dict[str, Any]]]:
    """GT pre-filters (reference ``evaluation_compute_scores.py:232,272``);
    missing properties pass."""
    out_g, out_p = [], []
    for g, p in zip(geoms, props):
        area = p.get("Area")
        if area is not None and area <= min_area:
            continue
        h = p.get("TreeHeight")
        if h is not None and h <= min_height:
            continue
        nd = p.get("MeanNDVI")
        if nd is not None and nd <= min_mean_ndvi:
            continue
        out_g.append(g)
        out_p.append(p)
    return out_g, out_p


def _bbox_candidates(pred_bounds: np.ndarray, gt_bounds: np.ndarray
                     ) -> List[Tuple[int, int]]:
    """All (pred, gt) pairs with overlapping bboxes — vectorized."""
    if len(pred_bounds) == 0 or len(gt_bounds) == 0:
        return []
    overlap = ((pred_bounds[:, None, 2] >= gt_bounds[None, :, 0]) &
               (gt_bounds[None, :, 2] >= pred_bounds[:, None, 0]) &
               (pred_bounds[:, None, 3] >= gt_bounds[None, :, 1]) &
               (gt_bounds[None, :, 3] >= pred_bounds[:, None, 1]))
    ii, jj = np.where(overlap)
    return list(zip(ii.tolist(), jj.tolist()))


def greedy_iou_match(predictions: Sequence[np.ndarray],
                     ground_truth: Sequence[np.ndarray],
                     iou_threshold: float = 0.5,
                     exact: bool = True
                     ) -> Tuple[List[Tuple[int, int, float]], List[int], List[int]]:
    """Greedy one-to-one matching by descending IoU (reference ``:55-111``).

    Candidate scoring uses the fast rasterized IoU; the IoU reported for
    each final match is recomputed EXACTLY (``exact=True``, signed
    triangle-decomposition clipping) so the instrument's own error
    (~1/512 per axis rasterized) never decides a parity gate like the
    0.99-IoU crown check.

    Returns (matches [(pred_idx, gt_idx, iou)], unmatched_pred, unmatched_gt).
    """
    pb = polygons_bounds(predictions) if len(predictions) else np.zeros((0, 4))
    gb = polygons_bounds(ground_truth) if len(ground_truth) else np.zeros((0, 4))
    pairs = _bbox_candidates(pb, gb)
    # Margin below the threshold so exact re-scoring can promote borderline
    # rasterized candidates rather than losing them.  The rasterized error is
    # ~(boundary cells)/(union cells); the grid spans the union bbox at 1/512,
    # so small/thin polygons see errors well above a fixed 0.02 — derive the
    # margin per pair from perimeter x cell size vs polygon area.

    def _perimeter(c: np.ndarray) -> float:
        d = np.diff(np.asarray(c, dtype=np.float64), axis=0)
        return float(np.hypot(d[:, 0], d[:, 1]).sum())

    scored = []
    for i, j in pairs:
        iou = polygon_iou(predictions[i], ground_truth[j])
        minx = min(pb[i, 0], gb[j, 0])
        miny = min(pb[i, 1], gb[j, 1])
        maxx = max(pb[i, 2], gb[j, 2])
        maxy = max(pb[i, 3], gb[j, 3])
        cell = max(maxx - minx, maxy - miny) / 512.0
        area = max(abs(polygon_area(predictions[i])),
                   abs(polygon_area(ground_truth[j])), cell * cell)
        per = _perimeter(predictions[i]) + _perimeter(ground_truth[j])
        margin = min(max(per * cell / area, 0.02), 0.5)
        if iou >= max(iou_threshold - margin, 0.0):
            scored.append((iou, i, j))
    scored.sort(reverse=True)
    matched_p: set = set()
    matched_g: set = set()
    matches: List[Tuple[int, int, float]] = []
    for iou, i, j in scored:
        if i in matched_p or j in matched_g:
            continue
        if exact:
            iou = polygon_iou_exact(predictions[i], ground_truth[j])
        if iou < iou_threshold:
            continue
        matched_p.add(i)
        matched_g.add(j)
        matches.append((i, j, iou))
    unmatched_p = [i for i in range(len(predictions)) if i not in matched_p]
    unmatched_g = [j for j in range(len(ground_truth)) if j not in matched_g]
    return matches, unmatched_p, unmatched_g


def evaluate(predictions: Sequence[np.ndarray], scores: Sequence[float],
             ground_truth: Sequence[np.ndarray],
             iou_threshold: float = 0.5,
             confidence_threshold: float = 0.3) -> Dict[str, float]:
    """P/R/F1 + mean matched IoU at one operating point (reference ``:113-138``)."""
    keep = [i for i, s in enumerate(scores) if s >= confidence_threshold]
    preds = [predictions[i] for i in keep]
    matches, un_p, un_g = greedy_iou_match(preds, ground_truth, iou_threshold)
    tp = len(matches)
    fp = len(un_p)
    fn = len(un_g)
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    mean_iou = float(np.mean([m[2] for m in matches])) if matches else 0.0
    return {"tp": tp, "fp": fp, "fn": fn, "precision": precision,
            "recall": recall, "f1": f1, "mean_iou": mean_iou,
            "iou_threshold": iou_threshold,
            "confidence_threshold": confidence_threshold}


def evaluate_grid(predictions: Sequence[np.ndarray], scores: Sequence[float],
                  ground_truth: Sequence[np.ndarray],
                  iou_thresholds: Sequence[float] = DEFAULT_IOU_THRESHOLDS,
                  conf_thresholds: Sequence[float] = DEFAULT_CONF_THRESHOLDS,
                  out_json: Optional[str] = None) -> List[Dict[str, float]]:
    """The reference's full threshold grid (reference ``:113-138``)."""
    results = [evaluate(predictions, scores, ground_truth, it, ct)
               for it in iou_thresholds for ct in conf_thresholds]
    if out_json:
        with open(out_json, "w") as fh:
            json.dump(results, fh, indent=1)
    return results


def visualize_results(predictions: Sequence[np.ndarray],
                      scores: Sequence[float],
                      ground_truth: Sequence[np.ndarray],
                      out_png: str, iou_threshold: float = 0.5,
                      confidence_threshold: float = 0.3) -> None:
    """TP (green) / FP (red) / FN (blue) overlay (reference ``:141-205``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    keep = [i for i, s in enumerate(scores) if s >= confidence_threshold]
    preds = [predictions[i] for i in keep]
    matches, un_p, un_g = greedy_iou_match(preds, ground_truth, iou_threshold)
    fig, ax = plt.subplots(figsize=(10, 10))

    def draw(ring, color, label=None):
        r = np.asarray(ring)
        ax.fill(r[:, 0], r[:, 1], alpha=0.4, color=color, label=label)

    for k, (i, j, _) in enumerate(matches):
        draw(preds[i], "green", "TP" if k == 0 else None)
    for k, i in enumerate(un_p):
        draw(preds[i], "red", "FP" if k == 0 else None)
    for k, j in enumerate(un_g):
        draw(ground_truth[j], "blue", "FN" if k == 0 else None)
    ax.set_aspect("equal")
    ax.legend()
    fig.savefig(out_png, dpi=120, bbox_inches="tight")
    plt.close(fig)


def annotation_boxes(geoms: Sequence[np.ndarray]) -> np.ndarray:
    """(N, 4) bounding boxes from crown polygons — used to derive box prompts
    from polygon annotations (reference
    ``segment_evaluation_cambridge.py:25-38``)."""
    return polygons_bounds(geoms)
