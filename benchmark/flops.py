"""The work of the model and of its ROIAlign pooler, counted from the
configuration's shapes (2 operations per multiply-add), and the chip's
published peaks.

``forward_flops`` counts the convolutions and dense layers of one tile's
forward at the model's input size: stem, bottlenecks and FPN, the RPN head on
P2-P6, the box head on every post-NMS proposal and the mask head on every
detection slot.  Resize, norms, activations, NMS and pooling are left out:
they are a small share and not matrix work.  ``roi_align_work`` counts what
aligned ROIAlign itself needs, whatever implements it: every output written
once and four bilinear samples of four taps per output.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, Tuple

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
FPN_STRIDES = (4, 8, 16, 32, 64)
PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())


def _conv(out_hw: int, k: int, cin: int, cout: int) -> int:
    """Multiply-adds of a conv with an ``out_hw`` square output."""
    return out_hw * out_hw * k * k * cin * cout


def backbone_macs(model: Dict) -> int:
    s = int(model["input_size"])
    macs = _conv(s // 2, 7, 3, 64)                      # stem, stride 2
    hw = s // 4                                         # after the max pool
    cin, width, cout = 64, 64, 256
    c_levels = []
    for stage, n in enumerate(STAGE_BLOCKS[int(model["depth"])]):
        if stage > 0:
            hw //= 2
        for i in range(n):
            src = cin if i == 0 else cout
            macs += (_conv(hw, 1, src, width) + _conv(hw, 3, width, width)
                     + _conv(hw, 1, width, cout))
            if i == 0:
                macs += _conv(hw, 1, src, cout)          # projection shortcut
        c_levels.append((hw, cout))
        cin, width, cout = cout, width * 2, cout * 2
    f = int(model["fpn_channels"])
    for hw_l, c in c_levels:
        macs += _conv(hw_l, 1, c, f) + _conv(hw_l, 3, f, f)
    return macs


def rpn_macs(model: Dict) -> int:
    s, f = int(model["input_size"]), int(model["fpn_channels"])
    a = len(model["anchor_ratios"])
    macs = 0
    for stride in FPN_STRIDES:
        hw = math.ceil(s / stride)
        macs += _conv(hw, 3, f, f) + _conv(hw, 1, f, a) + _conv(hw, 1, f, 4 * a)
    return macs


def box_head_macs(model: Dict) -> int:
    f, r = int(model["fpn_channels"]), int(model["box_pool"])
    d, k = int(model["box_head_fc_dim"]), int(model["num_classes"])
    per_box = f * r * r * d + d * d + d * (k + 1) + d * 4 * k
    return int(model["rpn_post_nms_topk"]) * per_box


def mask_head_macs(model: Dict) -> int:
    f, r = int(model["fpn_channels"]), int(model["mask_pool"])
    k = int(model["num_classes"])
    per_box = (4 * _conv(r, 3, f, f)          # four 3x3 convs
               + (2 * r) ** 2 * f * f          # 2x2/2 transposed conv
               + _conv(2 * r, 1, f, k))        # predictor
    return int(model["max_detections"]) * per_box


def forward_flops(model: Dict) -> int:
    """Operations of one tile's forward."""
    return 2 * (backbone_macs(model) + rpn_macs(model) + box_head_macs(model)
                + mask_head_macs(model))


def roi_align_work(n_boxes: int, res: int, channels: int,
                   out_bytes: int) -> Tuple[int, int]:
    """-> (operations, bytes) of pooling ``n_boxes`` boxes to res x res x
    channels: 2x2 samples per bin, 4 taps per sample, a multiply-add per
    tap; each output written once."""
    outputs = n_boxes * res * res * channels
    return outputs * 4 * 4 * 2, outputs * out_bytes


def roofline_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / PEAKS["flops_per_s"][dtype],
               nbytes / PEAKS["hbm_bytes_per_s"])
