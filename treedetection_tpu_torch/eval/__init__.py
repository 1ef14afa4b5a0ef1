"""Evaluation: greedy IoU matching, P/R/F1 grids, confidence sweeps, overlays
(counterpart of ``treedetection_tpu/eval``).

Parity with the reference's scientific evaluation tooling (reference
``supplementary/evaluation_compute_scores.py`` and
``supplementary/training_validation.py``) — the reference's substitute for a
test suite (SURVEY §4).
"""

from treedetection_tpu_torch.eval.scores import (  # noqa: F401
    greedy_iou_match, evaluate, evaluate_grid, filter_annotations,
    visualize_results)
from treedetection_tpu_torch.eval.validation import confidence_sweep  # noqa: F401
