"""Plain Mask R-CNN R-FPN inference in float32, the benchmark's reference.

detectron2's ``GeneralizedRCNN`` at inference, written out in plain PyTorch
operations over a checkpoint in the Flax ``.npz`` layout (``weights.py``):

* input: RGB uint8 tiles on a zero canvas -> BGR, minus the pixel mean,
  over the pixel std, bilinear resize (half-pixel centres) to the model's
  square input;
* ResNet with the stride on each first 1x1 conv (caffe style), frozen norms
  ``x * scale + bias``, a 3x3/2 max pool after the 7x7/2 stem;
* FPN with 256 channels, nearest top-down upsampling, P6 = P5 subsampled;
* RPN: 3x3 conv, per-level top-k of the objectness logits, deltas decoded
  (weights 1, scale clamp log(1000/16)) and clipped, NMS per level at 0.7,
  the post-NMS top-k over all levels;
* ROIAlign with aligned coordinates, a 2x2 sampling grid, detectron2's level
  assignment over P2-P5;
* box head: two 1024-wide FCs, softmax (class 0 is the crown), deltas with
  weights (10, 10, 5, 5), NMS at 0.5 over the boxes above the score
  threshold, the top detections;
* mask head: four 3x3 convs, a 2x2/2 transposed conv, a 1x1 predictor and
  a sigmoid.

Departures from detectron2, each the configuration's: no minimum box size in
the RPN, the input resized on the device without aspect handling (tiles are
square).  It imports no code of the program under test.

``Quant`` rounds the input and the weight of every conv and dense layer to a
lower precision: the benchmark's control.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

FPN_STRIDES = (4, 8, 16, 32, 64)
SCALE_CLAMP = math.log(1000.0 / 16.0)
BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}

Quant = Callable[[torch.Tensor], torch.Tensor]


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale per tensor (its absolute maximum
    onto 448, the format's largest value), back in float32."""
    amax = t.detach().abs().max()
    if not torch.isfinite(amax) or amax == 0:
        return t
    s = amax / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def load_checkpoint(path: str, device: torch.device) -> Dict[str, torch.Tensor]:
    """The ``.npz`` -> ``/``-joined key -> float32 tensor on ``device``, with
    each stacked ``res{s}_rest/block`` unstacked into ``res{s}_{i}``."""
    with np.load(path) as z:
        return tensors({k: z[k] for k in z.files}, device)


def tensors(arrays: Dict[str, np.ndarray],
            device: torch.device) -> Dict[str, torch.Tensor]:
    """Checkpoint arrays -> float32 tensors, stacked blocks unstacked."""
    out: Dict[str, torch.Tensor] = {}
    for key, a in arrays.items():
        arr = torch.from_numpy(np.asarray(a, dtype=np.float32))
        if "_rest/block/" in key:
            stage, leaf = key.split("_rest/block/")
            for i in range(arr.shape[0]):
                out[f"{stage}_{i + 1}/{leaf}"] = arr[i].to(device)
        else:
            out[key] = arr.to(device)
    return out


class Detections(NamedTuple):
    boxes: torch.Tensor      # (D, 4) in model-input pixels
    scores: torch.Tensor     # (D,)
    masks: torch.Tensor      # (D, 28, 28) sigmoid probabilities


class Candidates(NamedTuple):
    """Pre-NMS proposals of every level run through the box head."""
    boxes: torch.Tensor      # (K, 4) decoded and clipped
    scores: torch.Tensor     # (K,) crown probability


class MaskRCNN:
    """``MaskRCNN(weights, model)`` with ``model`` the configuration's model
    group; ``quant`` rounds each conv/dense input and weight."""

    def __init__(self, weights: Dict[str, torch.Tensor], model: Dict,
                 quant: Optional[Quant] = None):
        self.w = weights
        self.m = model
        self.q = quant or (lambda t: t)
        self.depth = int(model["depth"])
        self.size = int(model["input_size"])
        dev = next(iter(weights.values())).device
        self.anchors = [a.to(dev) for a in pyramid_anchors(
            self.size, model["anchor_sizes"], model["anchor_ratios"])]

    # -- layers --------------------------------------------------------------
    def conv(self, x: torch.Tensor, key: str, stride: int = 1,
             bias: bool = True) -> torch.Tensor:
        k = self.w[f"{key}/kernel"]                       # HWIO
        w = self.q(k.permute(3, 2, 0, 1).contiguous())
        b = self.w[f"{key}/bias"] if bias else None
        return F.conv2d(self.q(x), w, b, stride=stride,
                        padding=(k.shape[0] - 1) // 2)

    def conv_bn(self, x: torch.Tensor, key: str, stride: int = 1,
                relu: bool = True) -> torch.Tensor:
        y = self.conv(x, f"{key}/conv", stride, bias=False)
        y = (y * self.w[f"{key}/norm/scale"][:, None, None]
             + self.w[f"{key}/norm/bias"][:, None, None])
        return F.relu(y) if relu else y

    def dense(self, x: torch.Tensor, key: str) -> torch.Tensor:
        return (self.q(x) @ self.q(self.w[f"{key}/kernel"])
                + self.w[f"{key}/bias"])

    # -- the forward ---------------------------------------------------------
    def preprocess(self, tiles: torch.Tensor) -> torch.Tensor:
        """(B, P, P, 3) uint8 RGB -> (B, 3, S, S) normalized BGR."""
        mean = torch.tensor(self.m["pixel_mean"], dtype=torch.float32,
                            device=tiles.device)
        std = torch.tensor(self.m["pixel_std"], dtype=torch.float32,
                           device=tiles.device)
        x = (tiles[..., [2, 1, 0]].float() - mean) / std
        x = x.permute(0, 3, 1, 2)
        return F.interpolate(x, size=(self.size, self.size), mode="bilinear",
                             align_corners=False)

    def backbone(self, x: torch.Tensor) -> List[torch.Tensor]:
        bu = "params/backbone/bottom_up"
        x = self.conv_bn(x, f"{bu}/stem", stride=2)
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        cs = []
        for s, n in enumerate(STAGE_BLOCKS[self.depth]):
            for i in range(n):
                key = f"{bu}/res{s + 2}_{i}"
                stride = 2 if (i == 0 and s > 0) else 1
                short = (self.conv_bn(x, f"{key}/shortcut", stride, relu=False)
                         if i == 0 else x)
                y = self.conv_bn(x, f"{key}/conv1", stride)
                y = self.conv_bn(y, f"{key}/conv2")
                y = self.conv_bn(y, f"{key}/conv3", relu=False)
                x = F.relu(y + short)
            cs.append(x)
        fpn = "params/backbone/fpn"
        lat = [self.conv(c, f"{fpn}/lateral{i + 2}") for i, c in enumerate(cs)]
        for i in range(len(lat) - 2, -1, -1):
            lat[i] = lat[i] + F.interpolate(lat[i + 1], scale_factor=2,
                                            mode="nearest")
        outs = [self.conv(t, f"{fpn}/output{i + 2}") for i, t in enumerate(lat)]
        outs.append(outs[-1][:, :, ::2, ::2])
        return outs

    def rpn(self, feats: Sequence[torch.Tensor]):
        """-> per level (objectness (B, N_l), deltas (B, N_l, 4)), anchors
        fastest within each position, positions row-major."""
        out = []
        for f in feats:
            t = F.relu(self.conv(f, "params/rpn_head/conv"))
            lg = self.conv(t, "params/rpn_head/objectness_logits")
            dl = self.conv(t, "params/rpn_head/anchor_deltas")
            b = f.shape[0]
            out.append((lg.permute(0, 2, 3, 1).reshape(b, -1),
                        dl.permute(0, 2, 3, 1).reshape(b, -1, 4)))
        return out

    def proposals(self, rpn_out, i: int, pre_topk: Optional[int] = None):
        """Image ``i``: -> (per-level pre-NMS boxes, their logits), and the
        post-NMS proposals (boxes (K, 4), logits (K,)), score-descending.
        ``pre_topk`` widens the per-level top-k of the first pair only."""
        pre_boxes, pre_scores = [], []
        kept_boxes, kept_scores = [], []
        k_pre = int(self.m["rpn_pre_nms_topk"])
        for (lg, dl), an in zip(rpn_out, self.anchors):
            scores = lg[i]
            top, idx = torch.sort(scores, descending=True, stable=True)
            wide = min(pre_topk or k_pre, scores.shape[0])
            pre_boxes.append(clip(decode(dl[i][idx[:wide]], an[idx[:wide]],
                                         (1.0, 1.0, 1.0, 1.0)), self.size))
            pre_scores.append(top[:wide])
            k = min(k_pre, scores.shape[0])
            top, idx = top[:k], idx[:k]
            boxes = clip(decode(dl[i][idx], an[idx], (1.0, 1.0, 1.0, 1.0)),
                         self.size)
            keep = nms(boxes, top, float(self.m["rpn_nms_threshold"]))
            kept_boxes.append(boxes[keep])
            kept_scores.append(top[keep])
        boxes = torch.cat(kept_boxes)
        scores = torch.cat(kept_scores)
        order = torch.sort(scores, descending=True, stable=True).indices
        order = order[:int(self.m["rpn_post_nms_topk"])]
        return (pre_boxes, pre_scores), (boxes[order], scores[order])

    def box_features(self, feats, img: int,
                     boxes: torch.Tensor) -> torch.Tensor:
        """(N, 1024): the box head's second FC, after its ReLU."""
        pooled = roi_align(feats, img, boxes, int(self.m["box_pool"]))
        x = pooled.permute(0, 2, 3, 1).reshape(boxes.shape[0], -1)
        x = F.relu(self.dense(x, "params/box_head/fc1"))
        return F.relu(self.dense(x, "params/box_head/fc2"))

    def box_head(self, feats, img: int, boxes: torch.Tensor):
        """-> (crown probabilities (N,), decoded clipped boxes (N, 4))."""
        probs, decoded = [], []
        for start in range(0, boxes.shape[0], 1024):
            bx = boxes[start:start + 1024]
            x = self.box_features(feats, img, bx)
            logits = self.dense(x, "params/box_head/cls_score")
            deltas = self.dense(x, "params/box_head/bbox_pred")
            probs.append(torch.softmax(logits, dim=-1)[:, 0])
            decoded.append(clip(decode(deltas[:, :4], bx, BOX_WEIGHTS),
                                self.size))
        return torch.cat(probs), torch.cat(decoded)

    def mask_features(self, feats, img: int,
                      boxes: torch.Tensor) -> torch.Tensor:
        """(N, C, 2R, 2R): the mask head before its predictor."""
        x = roi_align(feats, img, boxes, int(self.m["mask_pool"]))
        for i in range(4):
            x = F.relu(self.conv(x, f"params/mask_head/mask_fcn{i + 1}"))
        # 2x2 stride-2 transposed conv: output pixel (2i+a, 2j+b) takes
        # input pixel (i, j) through the spatially flipped kernel tap (a, b)
        k = self.q(self.w["params/mask_head/deconv/kernel"].flip(0, 1))
        y = torch.einsum("nchw,abco->nohawb", self.q(x), k)
        n, o, h, _, w, _ = y.shape
        y = y.reshape(n, o, 2 * h, 2 * w) + \
            self.w["params/mask_head/deconv/bias"][:, None, None]
        return F.relu(y)

    def mask_head(self, feats, img: int, boxes: torch.Tensor) -> torch.Tensor:
        """-> (N, 2R, 2R) sigmoid probabilities of the crown class."""
        if boxes.shape[0] == 0:
            r2 = 2 * int(self.m["mask_pool"])
            return torch.zeros((0, r2, r2), device=boxes.device)
        logits = self.conv(self.mask_features(feats, img, boxes),
                           "params/mask_head/predictor")
        return torch.sigmoid(logits[:, 0])

    def features(self, tiles: torch.Tensor):
        """(B, P, P, 3) uint8 -> (FPN features, RPN outputs)."""
        feats = self.backbone(self.preprocess(tiles))
        return feats, self.rpn(feats)

    def detect(self, feats, rpn_out, img: int,
               cut: bool = True) -> Detections:
        """Image ``img``'s detections, score-descending; with ``cut`` the
        budget's top ones and their masks, else every one that NMS keeps
        above the score threshold (no masks)."""
        (_, _), (props, _) = self.proposals(rpn_out, img)
        probs, boxes = self.box_head(feats, img, props)
        ok = probs > float(self.m["score_threshold"])
        boxes, probs = boxes[ok], probs[ok]
        keep = nms(boxes, probs, float(self.m["nms_threshold"]))
        boxes, probs = boxes[keep], probs[keep]
        order = torch.sort(probs, descending=True, stable=True).indices
        if not cut:
            return Detections(boxes[order], probs[order], None)
        order = order[:int(self.m["max_detections"])]
        boxes, probs = boxes[order], probs[order]
        return Detections(boxes, probs, self.mask_head(feats[:4], img, boxes))

    def candidates(self, rpn_out, feats, img: int,
                   widen: int = 2) -> Candidates:
        """Every proposal of the per-level top ``widen`` x pre-NMS top-k,
        through the box head: wide enough that a proposal which entered
        the program's top-k on rounding is among them."""
        k = widen * int(self.m["rpn_pre_nms_topk"])
        (pre_boxes, _), _ = self.proposals(rpn_out, img, pre_topk=k)
        probs, boxes = self.box_head(feats, img, torch.cat(pre_boxes))
        return Candidates(boxes, probs)


# -- box arithmetic -------------------------------------------------------------

def pyramid_anchors(size: int, sizes: Sequence[float],
                    ratios: Sequence[float]) -> List[torch.Tensor]:
    """Per level (H*W*A, 4) anchors centred on the grid points (offset 0),
    positions row-major, anchors fastest."""
    out = []
    for stride, s in zip(FPN_STRIDES, sizes):
        base = []
        for r in ratios:
            w = math.sqrt(s * s / r)
            h = w * r
            base.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
        base = torch.tensor(base, dtype=torch.float32)
        n = int(math.ceil(size / stride))
        shift = torch.arange(n, dtype=torch.float32) * stride
        sy, sx = torch.meshgrid(shift, shift, indexing="ij")
        shifts = torch.stack([sx, sy, sx, sy], dim=-1)
        out.append((shifts[:, :, None, :] + base[None, None]).reshape(-1, 4))
    return out


def decode(deltas: torch.Tensor, boxes: torch.Tensor, weights) -> torch.Tensor:
    wx, wy, ww, wh = weights
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    cx = boxes[:, 0] + 0.5 * w
    cy = boxes[:, 1] + 0.5 * h
    dw = torch.clamp(deltas[:, 2] / ww, max=SCALE_CLAMP)
    dh = torch.clamp(deltas[:, 3] / wh, max=SCALE_CLAMP)
    pcx = deltas[:, 0] / wx * w + cx
    pcy = deltas[:, 1] / wy * h + cy
    pw = torch.exp(dw) * w
    ph = torch.exp(dh) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                        pcx + 0.5 * pw, pcy + 0.5 * ph], dim=1)


def clip(boxes: torch.Tensor, size: int) -> torch.Tensor:
    return boxes.clamp(0.0, float(size))


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, M) IoU; 0 where the union is empty."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[:, 2] - a[:, 0]).clamp(min=0)
              * (a[:, 3] - a[:, 1]).clamp(min=0))
    area_b = ((b[:, 2] - b[:, 0]).clamp(min=0)
              * (b[:, 3] - b[:, 1]).clamp(min=0))
    union = area_a[:, None] + area_b[None, :] - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-30),
                       torch.zeros_like(inter))


def nms(boxes: torch.Tensor, scores: torch.Tensor,
        threshold: float) -> torch.Tensor:
    """Greedy NMS, highest score first (ties: lower index first) -> indices
    of the kept boxes in ``boxes``' order."""
    order = torch.sort(scores, descending=True, stable=True).indices
    over = (iou(boxes[order], boxes[order]) > threshold).cpu().numpy()
    n = len(order)
    keep = np.ones(n, dtype=bool)
    for i in range(n):
        if keep[i]:
            keep[i + 1:] &= ~over[i, i + 1:]
    kept = order[torch.from_numpy(np.nonzero(keep)[0]).to(order.device)]
    return torch.sort(kept).values


# -- ROIAlign -------------------------------------------------------------------

def fpn_levels(boxes: torch.Tensor) -> torch.Tensor:
    """0-based level among P2..P5: floor(4 + log2(sqrt(area) / 224)),
    clamped to [2, 5]."""
    area = ((boxes[:, 2] - boxes[:, 0]).clamp(min=0)
            * (boxes[:, 3] - boxes[:, 1]).clamp(min=0))
    lvl = torch.floor(4 + torch.log2(torch.sqrt(area) / 224.0 + 1e-8))
    return (lvl.clamp(2, 5) - 2).to(torch.int64)


def roi_align(feats: Sequence[torch.Tensor], img: int, boxes: torch.Tensor,
              res: int) -> torch.Tensor:
    """(N, C, res, res): aligned ROIAlign with 2x2 samples per bin on each
    box's level of ``feats[:4]`` of image ``img``."""
    c = feats[0].shape[1]
    out = torch.zeros((boxes.shape[0], c, res, res), device=boxes.device)
    lv = fpn_levels(boxes)
    for level in range(4):
        sel = torch.nonzero(lv == level).flatten()
        if sel.numel():
            out[sel] = _roi_align_level(feats[level][img], boxes[sel],
                                        1.0 / FPN_STRIDES[level], res)
    return out


def _roi_align_level(fmap: torch.Tensor, boxes: torch.Tensor, scale: float,
                     res: int) -> torch.Tensor:
    c, h, w = fmap.shape
    b = boxes * scale - 0.5
    bin_w = (b[:, 2] - b[:, 0]) / res
    bin_h = (b[:, 3] - b[:, 1]) / res
    grid = (torch.arange(res, device=boxes.device, dtype=torch.float32)[:, None]
            + (torch.arange(2, device=boxes.device, dtype=torch.float32)
               + 0.5)[None] / 2).reshape(-1)                  # (res*2,)
    ys = b[:, 1:2] + grid[None] * bin_h[:, None]              # (N, 2res)
    xs = b[:, 0:1] + grid[None] * bin_w[:, None]

    def axis(t, size):
        inside = (t >= -1.0) & (t <= size)
        t = t.clamp(min=0)
        lo = torch.floor(t).to(torch.int64)
        at_end = lo >= size - 1
        lo = torch.where(at_end, torch.full_like(lo, size - 1), lo)
        hi = torch.where(at_end, lo, lo + 1)
        t = torch.where(at_end, lo.to(t.dtype), t)
        frac = t - lo.to(t.dtype)
        return lo, hi, frac, inside

    y0, y1, fy, iy = axis(ys, h)
    x0, x1, fx, ix = axis(xs, w)
    flat = fmap.reshape(c, h * w)
    # per box, the four corners of every sample: (n, 2, 2res, 2, 2res)
    rows = torch.stack([y0, y1], dim=1)
    cols = torch.stack([x0, x1], dim=1)
    wy = torch.stack([(1 - fy) * iy, fy * iy], dim=1)
    wx = torch.stack([(1 - fx) * ix, fx * ix], dim=1)
    out = []
    step = max(1, (1 << 24) // (c * 16 * res * res))
    for s in range(0, boxes.shape[0], step):
        sl = slice(s, s + step)
        idx = (rows[sl][:, :, :, None, None] * w
               + cols[sl][:, None, None])                       # (n,2,S,2,S)
        wt = wy[sl][:, :, :, None, None] * wx[sl][:, None, None]
        v = (flat[:, idx.reshape(-1)].reshape((c,) + idx.shape) * wt).sum(
            dim=(2, 4))                                         # (C, n, S, S)
        n = v.shape[1]
        out.append(v.reshape(c, n, res, 2, res, 2).mean(dim=(3, 5))
                   .permute(1, 0, 2, 3))
    return torch.cat(out)
