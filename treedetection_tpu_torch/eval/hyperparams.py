"""Postprocessing hyperparameter grid search (counterpart of
``treedetection_tpu/eval/hyperparams.py``, over the port's crown filter,
which runs on the config's ``device``).

Parity with reference ``supplementary/postprocessing_hyperparams.py`` — but
in-process instead of subprocess re-runs: the expensive prediction stage runs
once; only the (cheap, vectorized) postprocessing re-executes per parameter
combination, scored against annotations.
"""

from __future__ import annotations

import itertools
import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

# reference sweep values (postprocessing_hyperparams.py:6-11)
DEFAULT_GRID: Dict[str, Sequence[float]] = {
    "confidence_threshold": (0.3, 0.4, 0.5),
    "containment_threshold": (0.6, 0.75, 0.9),
    "iou_threshold": (0.4, 0.5, 0.6),
    "area_threshold": (1,),
    "ndvi_mean_threshold": (0.05, 0.1, 0.15),
    "ndvi_var_threshold": (0.05, 0.1, 0.2),
}


def sweep_postprocessing(stitched_gpkg: str,
                         annotations_gpkg: str,
                         base_config: Dict[str, Any],
                         height_path: Optional[str] = None,
                         rgbi_path: Optional[str] = None,
                         grid: Optional[Dict[str, Sequence]] = None,
                         eval_iou: float = 0.5,
                         out_json: Optional[str] = None
                         ) -> List[Dict[str, Any]]:
    """Run the crown filter for every parameter combination and score it.

    Returns results sorted by F1 (best first).
    """
    from treedetection_tpu_torch.postprocessing import (
        load_rasters_for_file, process_crowns)
    from treedetection_tpu_torch.eval.scores import evaluate, filter_annotations
    from treedetection_tpu_torch.vector import read_gpkg

    grid = grid or DEFAULT_GRID
    geoms, props, _ = read_gpkg(stitched_gpkg)
    crowns, scores = [], []
    for g, p in zip(geoms, props):
        if g and g[0]:
            crowns.append(np.asarray(g[0][0], dtype=np.float64))
            scores.append(float(p.get("Confidence_score", 0.0)))
    scores = np.asarray(scores, dtype=np.float32)

    a_geoms, a_props, _ = read_gpkg(annotations_gpkg)
    gts = [np.asarray(g[0][0]) for g in a_geoms if g and g[0]]
    gtp = [p for g, p in zip(a_geoms, a_props) if g and g[0]]
    gts, _ = filter_annotations(gts, gtp)

    hr, ha, nr, na, rb = load_rasters_for_file(height_path, rgbi_path,
                                               base_config)

    keys = list(grid)
    results: List[Dict[str, Any]] = []
    for combo in itertools.product(*(grid[k] for k in keys)):
        cfg = dict(base_config)
        cfg.update(dict(zip(keys, combo)))
        out_geoms, out_props = process_crowns(
            list(crowns), scores, cfg, hr, ha, nr, na, rb)
        out_scores = [p["Confidence_score"] for p in out_props]
        metrics = evaluate(out_geoms, out_scores, gts, eval_iou,
                           confidence_threshold=0.0)
        # combo LAST so the swept values are not shadowed by evaluate()'s
        # echo of its own confidence/iou arguments
        results.append({**metrics, **dict(zip(keys, combo)),
                        "n_crowns": len(out_geoms)})
    results.sort(key=lambda r: -r["f1"])
    if out_json:
        with open(out_json, "w") as fh:
            json.dump(results, fh, indent=1)
    return results
