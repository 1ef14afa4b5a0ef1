"""The full Mask R-CNN forward for a tile batch.

Counterpart of ``treedetection_tpu/models/mask_rcnn.py``: input is an
already-normalized NHWC batch, output a fixed-budget set of detections with
uint8 28x28 masks per image, plus the two truncated-pooling counters.
Backbone -> RPN -> proposal NMS -> box ROIAlign (K1) -> box head ->
detection NMS -> mask ROIAlign (K1) -> mask head.

The compute dtype is the dtype of the module's parameters: call
``model.to(torch.bfloat16)`` for the mixed-precision serving path (box
coordinates, scores and hat matrices stay float32 either way).  Training
sets ``bf16`` in the config instead: the parameters stay float32 and every
conv and dense layer casts them, with its input, to bfloat16 at each call,
as Flax's ``dtype`` does.  ``norm`` and ``remat`` select the backbone's
norm and recomputation (``models/resnet.py``); :func:`create_model`
initialises as Flax does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from treedetection_tpu_torch.models.anchors import pyramid_anchors
from treedetection_tpu_torch.models.layers import (
    init_like_flax, set_compute_dtype)
from treedetection_tpu_torch.models.resnet import ResNetFPN
from treedetection_tpu_torch.models.roi_heads import (
    BoxHead, MaskHead, box_inference)
from treedetection_tpu_torch.models.rpn import RPNHead, generate_proposals
from treedetection_tpu_torch.ops.roi_align import (
    PoolFn, multilevel_roi_align_batched)

FPN_STRIDES = (4, 8, 16, 32, 64)
# the forward's stages, in order, as ``MaskRCNN.forward`` marks their ends
STAGES = ("rpn", "proposals", "boxpool", "boxhead", "maskhead")


@dataclasses.dataclass(frozen=True)
class MaskRCNNConfig:
    depth: int = 101
    num_classes: int = 1
    input_size: int = 1024
    score_threshold: float = 0.3
    nms_threshold: float = 0.5
    rpn_pre_nms_topk: int = 1000
    rpn_post_nms_topk: int = 1000
    rpn_nms_threshold: float = 0.7
    max_detections: int = 100
    mask_pool: int = 14
    box_pool: int = 7
    anchor_sizes: Tuple[int, ...] = (32, 64, 128, 256, 512)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    # training: compute in bfloat16 over float32 parameters (the serving
    # path moves the whole model to bfloat16 instead, so the default is off)
    bf16: bool = False
    remat: bool = False     # recompute each bottleneck in the backward pass
    # backbone norm: "frozen" (serving, fine-tuning converted checkpoints) or
    # "batch" (from-scratch training; fold_batch_stats before serving)
    norm: str = "frozen"


class ModelOutput(NamedTuple):
    boxes: torch.Tensor         # (B, D, 4) in input-pixel coords
    scores: torch.Tensor        # (B, D)
    classes: torch.Tensor       # (B, D) int32
    valid: torch.Tensor         # (B, D) bool
    masks: torch.Tensor         # (B, D, 28, 28) uint8 sigmoid probability * 255
    roi_overflow: torch.Tensor  # (B,) int32 — VALID detections whose box-pool
                                # (via the source proposal) or mask-pool
                                # features stayed truncated
    prop_overflow: torch.Tensor  # (B,) int32 — truncated proposals in the top
                                # RPN-score quartile (a truncated proposal can
                                # silently suppress a detection)


class MaskRCNN(nn.Module):
    """Batched inference Mask R-CNN.  Call with a normalized (B, S, S, 3)
    float batch; ``S == cfg.input_size``."""

    def __init__(self, cfg: MaskRCNNConfig = MaskRCNNConfig()):
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNetFPN(depth=cfg.depth, norm=cfg.norm,
                                  remat=cfg.remat)
        self.rpn_head = RPNHead(num_anchors=len(cfg.anchor_ratios))
        self.box_head = BoxHead(in_features=256 * cfg.box_pool ** 2,
                                num_classes=cfg.num_classes)
        self.mask_head = MaskHead(num_classes=cfg.num_classes)
        # float32 anchors per device (not buffers: .to(bf16) must not touch them)
        self._anchors: Dict[torch.device, list] = {}
        if cfg.bf16:
            set_compute_dtype(self, torch.bfloat16)

    @property
    def compute_dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.cfg.bf16
                else next(self.parameters()).dtype)

    def anchors(self, device: torch.device) -> list:
        if device not in self._anchors:
            c = self.cfg
            self._anchors[device] = [
                torch.from_numpy(a).to(device) for a in pyramid_anchors(
                    c.input_size, FPN_STRIDES, sizes=c.anchor_sizes,
                    ratios=c.anchor_ratios)]
        return self._anchors[device]

    def forward(self, images: torch.Tensor,
                roi_pool: Optional[PoolFn] = None,
                mark: Optional[Callable[[str], None]] = None) -> ModelOutput:
        """Both ROIAlign calls pool through the layout that the environment
        selects at the call (``TD_ROI_FLAT``, ``TD_ROI_RESIDENT``; see
        ``ops/roi_align.py``): K1 on the flat buffer by default.  ``roi_pool``
        replaces the flat layout's pooler, e.g. by K1's plain version; it is
        refused with another layout.  ``mark``, if given, is called with the
        name of each stage of ``STAGES`` once its work is enqueued (the
        bench records a CUDA event there)."""
        c = self.cfg
        dtype = self.compute_dtype
        b = images.shape[0]
        mark = mark or (lambda stage: None)
        feats, logits, deltas = self.forward_features(images)
        mark("rpn")
        props = generate_proposals(
            logits, deltas, self.anchors(images.device), c.input_size,
            c.rpn_pre_nms_topk, c.rpn_post_nms_topk, c.rpn_nms_threshold)
        k = props.boxes.shape[1]
        mark("proposals")

        feats4 = feats[:4]
        pooled, box_inexact = multilevel_roi_align_batched(
            feats4, props.boxes, c.box_pool, FPN_STRIDES[:4], pool=roi_pool)
        mark("boxpool")
        cls_logits, box_deltas = self.box_head(
            pooled.reshape((b * k,) + pooled.shape[2:]).to(dtype))
        det = box_inference(
            cls_logits.reshape(b, k, -1), box_deltas.reshape(b, k, -1),
            props.boxes, props.scores, c.input_size, c.score_threshold,
            c.nms_threshold, c.max_detections)
        d = det.boxes.shape[1]
        mark("boxhead")

        mask_pooled, mask_inexact = multilevel_roi_align_batched(
            feats4, det.boxes, c.mask_pool, FPN_STRIDES[:4], pool=roi_pool)
        mask_logits = self.mask_head(
            mask_pooled.reshape((b * d,) + mask_pooled.shape[2:]).to(dtype))
        probs = torch.sigmoid(mask_logits[..., 0])           # (B*D, 28, 28)
        masks = torch.round(probs * 255.0).to(torch.uint8)
        mark("maskhead")
        masks = masks.reshape((b, d) + masks.shape[1:])
        # degraded-output counters (see ModelOutput)
        det_box_trunc = torch.gather(box_inexact, 1, det.src)
        degraded = (det.valid & (det_box_trunc | mask_inexact)).sum(dim=1)
        top_prop_trunc = box_inexact[:, :max(k // 4, 1)].sum(dim=1)
        return ModelOutput(boxes=det.boxes, scores=det.scores,
                           classes=det.classes, valid=det.valid, masks=masks,
                           roi_overflow=degraded.to(torch.int32),
                           prop_overflow=top_prop_trunc.to(torch.int32))

    def forward_features(self, images: torch.Tensor):
        """Backbone + RPN head: normalized (B, S, S, 3) -> ([P2..P6] NHWC,
        RPN logits per level, RPN deltas per level), in the compute dtype."""
        feats = self.backbone(images.to(self.compute_dtype))
        logits, deltas = self.rpn_head(feats)
        return feats, logits, deltas


def create_model(cfg: Optional[MaskRCNNConfig] = None,
                 generator: Optional[torch.Generator] = None) -> MaskRCNN:
    """A randomly initialised model on the CPU, from Flax's initialisers:
    conv, deconv and dense kernels ``lecun_normal``, biases 0, norm scales 1
    (0 on each bottleneck's ``conv3`` under batch norm), running mean 0 and
    variance 1.  ``generator`` defaults to one seeded with 0.  Use
    ``models.convert`` to load a checkpoint."""
    cfg = cfg or MaskRCNNConfig()
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = MaskRCNN(cfg)
    init_like_flax(model, generator)
    return model
