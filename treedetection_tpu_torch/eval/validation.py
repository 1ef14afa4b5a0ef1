"""Validation sweep: confidence 0.05-0.95 -> best-F1 operating point
(counterpart of ``treedetection_tpu/eval/validation.py``).

Parity with reference ``supplementary/training_validation.py`` (metric loop at
``:86-126``, sweep at ``:371-380``): run the pipeline output against hand
annotations, sweep the confidence threshold, plot P/R/F1, pick the best F1.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from treedetection_tpu_torch.eval.scores import evaluate, filter_annotations
from treedetection_tpu_torch.vector import read_gpkg


def confidence_sweep(predictions: Sequence[np.ndarray],
                     scores: Sequence[float],
                     ground_truth: Sequence[np.ndarray],
                     iou_threshold: float = 0.5,
                     confidences: Optional[Sequence[float]] = None,
                     plot_path: Optional[str] = None
                     ) -> Tuple[float, List[Dict[str, float]]]:
    """-> (best-F1 confidence, per-confidence metric dicts)."""
    if confidences is None:
        confidences = np.arange(0.05, 0.96, 0.05)
    results = [evaluate(predictions, scores, ground_truth, iou_threshold, c)
               for c in confidences]
    best = max(results, key=lambda r: r["f1"])
    if plot_path:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        cs = [r["confidence_threshold"] for r in results]
        fig, ax = plt.subplots()
        ax.plot(cs, [r["precision"] for r in results], label="precision")
        ax.plot(cs, [r["recall"] for r in results], label="recall")
        ax.plot(cs, [r["f1"] for r in results], label="F1")
        ax.axvline(best["confidence_threshold"], ls="--", c="gray")
        ax.set_xlabel("confidence threshold")
        ax.legend()
        fig.savefig(plot_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return float(best["confidence_threshold"]), results


def evaluate_gpkg_pair(pred_gpkg: str, gt_gpkg: str,
                       iou_threshold: float = 0.5,
                       confidence_threshold: float = 0.3) -> Dict[str, float]:
    """Score one processed output file against an annotation file."""
    p_geoms, p_props, _ = read_gpkg(pred_gpkg)
    g_geoms, g_props, _ = read_gpkg(gt_gpkg)
    preds = [np.asarray(g[0][0]) for g in p_geoms if g and g[0]]
    scores = [float(p.get("Confidence_score", 0.0))
              for g, p in zip(p_geoms, p_props) if g and g[0]]
    gts = [np.asarray(g[0][0]) for g in g_geoms if g and g[0]]
    gtp = [p for g, p in zip(g_geoms, g_props) if g and g[0]]
    gts, _ = filter_annotations(gts, gtp)
    return evaluate(preds, scores, gts, iou_threshold, confidence_threshold)
