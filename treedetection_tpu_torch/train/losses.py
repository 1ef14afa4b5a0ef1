"""Mask R-CNN training losses with static-shape target assignment.

Counterpart of ``treedetection_tpu/train/losses.py`` (detectron2's
objectives with every dynamic shape replaced by a padded budget):

* RPN: objectness cross-entropy + L1 on anchor deltas (positive: IoU >= 0.7
  with a GT, or the best anchor of a GT; negative: IoU < 0.3);
* ROI box head: softmax cross-entropy (fg/bg) + L1 on the deltas of the
  foreground proposals (IoU >= 0.5);
* mask head: per-pixel BCE against the matched GT mask ROI-aligned to the
  proposal, on a static budget of foreground proposals.

The JAX functions ``vmap`` over images; these take the batch as a leading
dimension and give the same result per image.  The losses are means over
images of per-image losses, as there.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from treedetection_tpu_torch.models.mask_rcnn import FPN_STRIDES
from treedetection_tpu_torch.models.resnet import (
    collect_batch_stats, updated_batch_stats)
from treedetection_tpu_torch.models.roi_heads import BOX_REG_WEIGHTS
from treedetection_tpu_torch.models.rpn import generate_proposals
from treedetection_tpu_torch.ops.boxes import box_iou_matrix, encode_deltas
from treedetection_tpu_torch.ops.nms import stable_topk
from treedetection_tpu_torch.ops.roi_align import (
    multilevel_roi_align, roi_align)

# detectron2's ROI-head sampler (512 proposals per image, at most 25% fg),
# reproduced by its EXPECTED weighting over every proposal
ROI_BATCH_PER_IMAGE = 512
ROI_FG_CAP = 128
MASK_FG_BUDGET = 128        # static mask-loss subset (d2 pools only sampled fg)
MASK_DOWNSAMPLE = 4         # GT masks stored at input_size/4


def smooth_l1(x: torch.Tensor, beta: float = 0.0) -> torch.Tensor:
    if beta <= 0:
        return torch.abs(x)
    return torch.where(torch.abs(x) < beta, 0.5 * x * x / beta,
                       torch.abs(x) - 0.5 * beta)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (no linear cutoff)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


class GroundTruth(NamedTuple):
    boxes: torch.Tensor    # (B, G, 4) padded
    masks: torch.Tensor    # (B, G, Hm, Wm) binary, at input_size/4
    valid: torch.Tensor    # (B, G) bool


def _take(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[b, idx[b, k]]`` for (B, N, ...) values and (B, K) indices."""
    b, k = idx.shape
    flat = values.reshape(b, values.shape[1], -1)
    out = torch.gather(flat, 1, idx[..., None].expand(b, k, flat.shape[-1]))
    return out.reshape((b, k) + values.shape[2:])


def assign_anchors(anchors: torch.Tensor, gt: GroundTruth,
                   pos_iou: float = 0.7, neg_iou: float = 0.3
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``anchors`` (A, 4) -> (labels (B, A) in {1 pos, 0 neg, -1 ignore},
    matched GT index (B, A))."""
    iou = box_iou_matrix(anchors, gt.boxes)                   # (B, A, G)
    iou = torch.where(gt.valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best_iou, best_gt = iou.max(dim=2)
    labels = torch.where(best_iou >= pos_iou, 1,
                         torch.where(best_iou < neg_iou, 0, -1))
    # force-match the best anchor of each valid GT (a MAX scatter: padding
    # GTs all point at anchor 0 and must not clear a valid GT's positive)
    best_anchor = iou.argmax(dim=1)                           # (B, G)
    forced = torch.zeros_like(labels).scatter_reduce(
        1, best_anchor, gt.valid.to(labels.dtype), reduce="amax") > 0
    return torch.where(forced, 1, labels), best_gt


def rpn_loss(logits: Sequence[torch.Tensor], deltas: Sequence[torch.Tensor],
             anchors: Sequence[torch.Tensor], gt: GroundTruth,
             batch_per_image: int = 256,
             pos_fraction: float = 0.5) -> Dict[str, torch.Tensor]:
    """RPN objectness + regression loss per image, (B,) each.  Every anchor
    counts, weighted as detectron2's sampler of ``batch_per_image`` anchors
    with at most ``pos_fraction`` positives weights them in expectation."""
    b = gt.boxes.shape[0]
    all_logits = torch.cat([lg.reshape(b, -1) for lg in logits], dim=1)
    all_deltas = torch.cat([d.reshape(b, -1, 4) for d in deltas], dim=1)
    all_anchors = torch.cat(list(anchors))
    labels, matched = assign_anchors(all_anchors, gt)

    pos = labels == 1
    neg = labels == 0
    n_pos = torch.clamp(pos.sum(dim=1), min=1)
    n_neg = torch.clamp(neg.sum(dim=1), min=1)
    pos_cap = batch_per_image * pos_fraction
    n_pos_eff = torch.clamp(n_pos.to(torch.float32), max=pos_cap)
    w_pos = torch.clamp(pos_cap / n_pos, max=1.0)
    w_neg = torch.clamp((batch_per_image - n_pos_eff) / n_neg, max=1.0)
    zero = torch.zeros((), dtype=all_logits.dtype, device=all_logits.device)
    objectness = (w_pos * torch.where(pos, _softplus(-all_logits), zero).sum(1)
                  + w_neg * torch.where(neg, _softplus(all_logits), zero).sum(1)
                  ) / batch_per_image

    target = encode_deltas(all_anchors, _take(gt.boxes, matched))
    reg = smooth_l1(all_deltas - target).sum(dim=-1)
    regression = w_pos * torch.where(pos, reg, 0.0).sum(1) / batch_per_image
    return {"rpn_objectness": objectness, "rpn_regression": regression}


def assign_proposals(proposals: torch.Tensor, proposal_valid: torch.Tensor,
                     gt: GroundTruth, fg_iou: float = 0.5):
    """(B, K, 4) proposals -> (fg, bg, best_gt, best_iou), (B, K) each."""
    iou = box_iou_matrix(proposals, gt.boxes)
    iou = torch.where(gt.valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best_iou, best_gt = iou.max(dim=2)
    fg = (best_iou >= fg_iou) & proposal_valid
    bg = (best_iou < fg_iou) & proposal_valid
    return fg, bg, best_gt, best_iou


def roi_box_losses(cls_logits: torch.Tensor, box_deltas: torch.Tensor,
                   proposals: torch.Tensor, fg: torch.Tensor, bg: torch.Tensor,
                   best_gt: torch.Tensor, gt: GroundTruth
                   ) -> Dict[str, torch.Tensor]:
    """Box-head CE + L1 per image: ``cls_logits`` (B, K, 2), ``box_deltas``
    (B, K, 4) on ``proposals`` (B, K, 4); class 0 is the tree."""
    n_fg = torch.clamp(fg.sum(dim=1), min=1)
    n_bg = torch.clamp(bg.sum(dim=1), min=1)
    n_fg_eff = torch.clamp(n_fg, max=ROI_FG_CAP)
    w_fg = torch.clamp(ROI_FG_CAP / n_fg, max=1.0)
    w_bg = torch.clamp((ROI_BATCH_PER_IMAGE - n_fg_eff) / n_bg, max=1.0)
    log_probs = torch.log_softmax(cls_logits, dim=-1)
    cls_loss = -(w_fg * torch.where(fg, log_probs[..., 0], 0.0).sum(1)
                 + w_bg * torch.where(bg, log_probs[..., 1], 0.0).sum(1)
                 ) / ROI_BATCH_PER_IMAGE
    target = encode_deltas(proposals, _take(gt.boxes, best_gt),
                           BOX_REG_WEIGHTS)
    reg = smooth_l1(box_deltas - target).sum(dim=-1)
    box_loss = w_fg * torch.where(fg, reg, 0.0).sum(1) / ROI_BATCH_PER_IMAGE
    return {"cls": cls_loss, "box_reg": box_loss}


def roi_mask_loss(mask_logits: torch.Tensor, proposals: torch.Tensor,
                  fg: torch.Tensor, best_gt: torch.Tensor, gt: GroundTruth
                  ) -> torch.Tensor:
    """Mask BCE per image on an (M,)-selected proposal subset: the matched
    GT mask (stored at input_size / MASK_DOWNSAMPLE) ROI-aligned to each
    proposal at R x R.  ``mask_logits`` (B, M, R, R)."""
    b, m, r = mask_logits.shape[:3]
    hm = gt.masks.shape[-2]
    assert gt.masks.shape[-1] == hm, "square GT mask rasters expected"
    matched = _take(gt.masks, best_gt).to(torch.float32)      # (B, M, Hm, Wm)
    with torch.no_grad():
        targets = roi_align(
            matched.reshape(b * m, hm, hm, 1),
            proposals.reshape(b * m, 4) / MASK_DOWNSAMPLE, r,
            spatial_scale=1.0, sampling_ratio=2)[..., 0].reshape(b, m, r, r)
        targets = (targets > 0.5).to(torch.float32)
    lg = mask_logits
    bce = (torch.clamp(lg, min=0) - lg * targets
           + torch.log1p(torch.exp(-torch.abs(lg))))
    n_fg = torch.clamp(fg.sum(dim=1), min=1)
    return (torch.where(fg[..., None, None], bce, 0.0).sum(dim=(1, 2, 3))
            / (n_fg * r * r))


def _pool(feats: Sequence[torch.Tensor], boxes: torch.Tensor,
          resolution: int) -> torch.Tensor:
    """The differentiable pooler image by image on float32 features:
    (B, N, 4) boxes -> (B, N, R, R, C)."""
    return torch.stack([
        multilevel_roi_align([f[i].float() for f in feats], boxes[i],
                             resolution, FPN_STRIDES[:4], differentiable=True)
        for i in range(boxes.shape[0])])


def mask_rcnn_losses(model, images: torch.Tensor, gt_boxes: torch.Tensor,
                     gt_masks: torch.Tensor, gt_valid: torch.Tensor,
                     return_state: bool = False):
    """Full training loss of a batch -> (total, parts), or with
    ``return_state`` (total, (parts, state)): ``state`` holds the backbone's
    running statistics after this step as state-dict entries (empty unless
    the model has batch norm); the caller loads them after its update.

    ``images`` (B, S, S, 3) normalized; ``gt_boxes`` (B, G, 4) in
    input-pixel coordinates; ``gt_masks`` (B, G, S/4, S/4) binary;
    ``gt_valid`` (B, G).  Runs backbone + RPN, selects proposals (no
    gradient), appends the GT boxes to them (detectron2), and runs the box
    and mask heads on the pooled features.
    """
    cfg = model.cfg
    dtype = model.compute_dtype
    with collect_batch_stats() as stats:
        feats, logits, deltas = model.forward_features(images)
    state = updated_batch_stats(model, stats) if return_state else {}
    anchors = model.anchors(images.device)
    gt = GroundTruth(boxes=gt_boxes, masks=gt_masks, valid=gt_valid)
    losses = rpn_loss(logits, deltas, anchors, gt)
    with torch.no_grad():
        props = generate_proposals(
            [lg.detach() for lg in logits], [d.detach() for d in deltas],
            anchors, cfg.input_size, cfg.rpn_pre_nms_topk,
            cfg.rpn_post_nms_topk, cfg.rpn_nms_threshold)
    prop_boxes = torch.cat([props.boxes, gt_boxes], dim=1)
    prop_valid = torch.cat([props.scores > float("-inf"), gt_valid], dim=1)
    fg, bg, best_gt, best_iou = assign_proposals(prop_boxes, prop_valid, gt)
    b, n = prop_boxes.shape[:2]

    pooled = _pool(feats[:4], prop_boxes, cfg.box_pool)
    cls_logits, box_deltas = model.box_head(
        pooled.reshape((b * n,) + pooled.shape[2:]).to(dtype))
    losses.update(roi_box_losses(
        cls_logits.reshape(b, n, -1), box_deltas.reshape(b, n, -1)[..., :4],
        prop_boxes, fg, bg, best_gt, gt))

    # the mask head only on a static fg budget, highest IoU first
    m = min(MASK_FG_BUDGET, n)
    _, sel = stable_topk(torch.where(fg, best_iou, -1.0), m)
    sel_boxes = _take(prop_boxes, sel)
    mask_pooled = _pool(feats[:4], sel_boxes, cfg.mask_pool)
    mask_logits = model.mask_head(
        mask_pooled.reshape((b * m,) + mask_pooled.shape[2:]).to(dtype))
    losses["mask"] = roi_mask_loss(
        mask_logits[..., 0].reshape((b, m) + mask_logits.shape[1:3]),
        sel_boxes, _take(fg, sel), _take(best_gt, sel), gt)

    mean_losses = {k: v.mean() for k, v in losses.items()}
    total = sum(mean_losses.values())
    if return_state:
        return total, (mean_losses, state)
    return total, mean_losses
