"""Model/ablation comparison plots (counterpart of
``treedetection_tpu/eval/plots.py``; matplotlib is imported inside).

Parity with reference ``supplementary/evaluation_plot_automatic.py``
(``:14-60``): F1 / precision / recall curves over confidence per model per
site category, from the JSON result files ``evaluate_grid`` writes.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional


def plot_results(result_files: Dict[str, str], out_png: str,
                 metric: str = "f1", iou_threshold: float = 0.5,
                 title: Optional[str] = None) -> None:
    """``result_files``: model-name -> evaluate_grid JSON path.  Draws one
    curve per model: ``metric`` vs confidence at the given IoU threshold."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    for name, path in result_files.items():
        with open(path) as fh:
            results = json.load(fh)
        points = sorted(
            ((r["confidence_threshold"], r[metric]) for r in results
             if abs(r["iou_threshold"] - iou_threshold) < 1e-9))
        if not points:
            continue
        xs, ys = zip(*points)
        ax.plot(xs, ys, marker="o", label=name)
    ax.set_xlabel("confidence threshold")
    ax.set_ylabel(metric)
    ax.set_ylim(0, 1)
    ax.grid(alpha=0.3)
    ax.legend(fontsize=8)
    if title:
        ax.set_title(title)
    fig.savefig(out_png, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_site_categories(results_by_site: Dict[str, Dict[str, str]],
                         out_dir: str, metric: str = "f1",
                         iou_threshold: float = 0.5) -> List[str]:
    """One plot per site category (Village/Countryside/City/Forest in the
    reference's ablations, ``evaluation_plot_automatic.py:18-28``)."""
    os.makedirs(out_dir, exist_ok=True)
    out = []
    for site, files in results_by_site.items():
        path = os.path.join(out_dir, f"{metric}_{site}.png")
        plot_results(files, path, metric, iou_threshold, title=site)
        out.append(path)
    return out
