"""Static-shape greedy NMS as a fixpoint over the suppression matrix.

Counterpart of ``treedetection_tpu/ops/nms.py``; batched over any leading
dimensions so the RPN's per-level NMS of a whole tile batch is one call.
"""

from __future__ import annotations

import torch

from treedetection_tpu_torch.ops.boxes import box_iou_matrix

# sweeps run between convergence checks: each check is one device->host
# sync, and sweeps past the fixpoint change nothing
_SWEEPS_PER_CHECK = 8


def stable_topk(values: torch.Tensor, k: int):
    """Top-k along the last dim with ties broken toward the LOWER index —
    ``jax.lax.top_k``'s documented order, which ``torch.topk`` does not
    promise.  -> (values, indices)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
             iou_threshold: float) -> torch.Tensor:
    """Greedy NMS -> bool keep-mask in the ORIGINAL box order.

    ``boxes`` (..., N, 4), ``scores`` (..., N).  Boxes are visited in
    descending score order (stable sort, so tied scores keep index order as
    ``jnp.argsort`` does); a box is kept iff no earlier kept box overlaps it
    with IoU > threshold.  ``-inf`` scores are never kept.

    Greedy keep is the unique fixpoint of ``keep[i] = valid[i] and not
    any(j < i and keep[j] and iou[j, i] > t)``; iterating that map from
    ``valid`` settles decisions prefix-first, so each sweep is one parallel
    masked reduction and the loop ends after the suppression-chain depth.
    """
    n = boxes.shape[-2]
    order = torch.sort(-scores, dim=-1, stable=True).indices
    sorted_boxes = torch.gather(
        boxes, -2, order.unsqueeze(-1).expand(*order.shape, 4))
    sorted_scores = torch.gather(scores, -1, order)
    iou = box_iou_matrix(sorted_boxes, sorted_boxes)
    upper = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    # [..., j, i] = 1 where j < i and iou > t, as 0/1 values of a matmul
    # type: a sweep's "any kept j suppresses i" is then one batched
    # vector-matrix product (exact in float16 too: only "count == 0" is
    # read, and a sum of 0/1 terms is 0 only when every term is)
    mm_dtype = torch.float16 if boxes.is_cuda else torch.float32
    suppress = ((iou > iou_threshold) & upper).to(mm_dtype)
    valid = sorted_scores > float("-inf")

    keep = valid
    for _ in range(0, n + 1, _SWEEPS_PER_CHECK):
        for _sweep in range(_SWEEPS_PER_CHECK):
            prev = keep
            hits = torch.matmul(keep.to(mm_dtype).unsqueeze(-2), suppress)
            keep = valid & (hits.squeeze(-2) == 0)
        if torch.equal(keep, prev):
            break
    return torch.zeros_like(keep).scatter(-1, order, keep)
