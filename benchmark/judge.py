"""The comparison that decides ``correct``: the program's detections
against the float32 reference's, judged by what they say.

Per tile the reference gives (``reference.maskrcnn``):

* its own detections (after NMS, above the score threshold, cut to the
  detection budget);
* its candidates: the per-level top 2k pre-NMS proposals (k the program's
  top-k) run through the box head, so that a program detection whose
  proposal or NMS decision flipped on rounding still finds the detection
  it stands for;
* its masks on the program's own boxes.

The gap between two detections is max(1 - IoU, |score difference|), boxes
grown by 1 px.  The numbers:

* ``det_gap_mean``: the mean, over every valid program detection of the
  judged tiles, of its least gap to the reference's candidates: what moved
  every box or score a little (a decode or a norm gone wrong);
* ``mask_gap``: the widest, over the judged detections, mean absolute
  difference between a detection's mask and the reference's mask on its
  box;
* ``det_missed``: the share of the reference's due detections (in each
  tile the upper half by score) whose least gap to the valid program
  detections of the same tile is over ``MISSED_GAP``: what the program
  left out (a tile with no valid detection misses every one).

Reported beside them, not compared (each leaves less room between sound
runs and the control than the numbers above): ``det_gap_p99`` and
``det_gap_max``, the 99th percentile and the widest of the same gaps,
``det_count_gap``, |valid program detections - reference detections| over
the reference's, summed over every judged tile, and
``det_missed_above_half``, the missed share of the reference's detections
scoring over 0.5.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import numpy as np

# det_missed: a reference detection is missed where no program detection
# lies within this gap of it (IoU under a half, or the score half a unit
# away)
MISSED_GAP = 0.5


class TileOutput(NamedTuple):
    """One tile of the program's (or the control's) output."""
    boxes: np.ndarray    # (D, 4) model-input pixels
    scores: np.ndarray   # (D,)
    masks: np.ndarray    # (D, 28, 28) probabilities in [0, 1]
    valid: np.ndarray    # (D,) bool


class TileReference(NamedTuple):
    det_boxes: np.ndarray     # (R, 4)
    det_scores: np.ndarray    # (R,)
    cand_boxes: np.ndarray    # (K, 4)
    cand_scores: np.ndarray   # (K,)
    masks_on_program: np.ndarray  # (D_valid, 28, 28) on the judged boxes


def iou(a: np.ndarray, b: np.ndarray, pad: float = 0.0) -> np.ndarray:
    """(N, M) IoU of boxes grown by ``pad`` on every side (a pad keeps two
    equal boxes of no area at IoU 1)."""
    a = np.asarray(a, np.float64).reshape(-1, 4) + np.array([-pad, -pad,
                                                             pad, pad])
    b = np.asarray(b, np.float64).reshape(-1, 4) + np.array([-pad, -pad,
                                                             pad, pad])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.prod(np.clip(a[:, 2:] - a[:, :2], 0, None), axis=1)
    area_b = np.prod(np.clip(b[:, 2:] - b[:, :2], 0, None), axis=1)
    union = area_a[:, None] + area_b[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / union, 0.0)


def _gaps(boxes: np.ndarray, scores: np.ndarray, to_boxes: np.ndarray,
          to_scores: np.ndarray) -> np.ndarray:
    """Per detection of the first set, its least gap to the second (1
    where the second is empty)."""
    if not len(boxes):
        return np.zeros(0)
    if not len(to_boxes):
        return np.ones(len(boxes))
    m = iou(boxes, to_boxes, pad=1.0)
    ds = np.abs(np.asarray(scores)[:, None] - np.asarray(to_scores)[None, :])
    return np.min(np.maximum(1.0 - m, ds), axis=1)


def detection_gaps(out: TileOutput, ref: TileReference) -> np.ndarray:
    """Per valid program detection, its gap to the reference's
    candidates."""
    v = np.asarray(out.valid, bool)
    return _gaps(out.boxes[v], out.scores[v], ref.cand_boxes,
                 ref.cand_scores)


def tile_numbers(out: TileOutput, ref: TileReference) -> Dict:
    """-> the gaps of one tile's detections, those of the reference's due
    detections to the program's, and the counts."""
    v = np.asarray(out.valid, bool)
    boxes = out.boxes[v]
    mask = (np.mean(np.abs(out.masks[v] - ref.masks_on_program),
                    axis=(1, 2)) if len(boxes) else np.zeros(0))
    ref_gaps = _gaps(ref.det_boxes, ref.det_scores, boxes, out.scores[v])
    # the upper half by score: the reference's detections come
    # score-descending
    half = (len(ref_gaps) + 1) // 2
    return {"gaps": detection_gaps(out, ref), "mask": mask,
            "due_gaps": ref_gaps[:half],
            "above_half_gaps": ref_gaps[ref.det_scores > 0.5],
            "n": float(len(boxes)), "n_ref": float(len(ref.det_scores))}


def summarize(per_tile: Sequence[Dict]) -> Dict[str, float]:
    """The cell's numbers over every judged tile."""
    gaps = np.concatenate([t["gaps"] for t in per_tile] or [np.zeros(0)])
    masks = np.concatenate([t["mask"] for t in per_tile] or [np.zeros(0)])
    due = np.concatenate([t["due_gaps"] for t in per_tile] or [np.zeros(0)])
    above = np.concatenate([t["above_half_gaps"] for t in per_tile]
                           or [np.zeros(0)])
    n = sum(t["n"] for t in per_tile)
    n_ref = sum(t["n_ref"] for t in per_tile)

    def missed(g):
        return float(np.mean(g > MISSED_GAP)) if len(g) else 0.0

    return {
        "det_gap_mean": float(gaps.mean()) if len(gaps) else 0.0,
        "mask_gap": float(masks.max()) if len(masks) else 0.0,
        "det_missed": missed(due),
        "det_gap_p99": float(np.quantile(gaps, 0.99)) if len(gaps) else 0.0,
        "det_gap_max": float(gaps.max()) if len(gaps) else 0.0,
        "det_count_gap": abs(n - n_ref) / n_ref if n_ref else float(n > 0),
        "det_missed_above_half": missed(above),
        "judged_detections": float(n),
        "due_detections": float(len(due)),
    }


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number is at or under its limit (a number that is
    not finite fails)."""
    return all(np.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in limits)
