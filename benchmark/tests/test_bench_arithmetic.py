"""The yardstick's arithmetic: the model's operation count against a hand
count and against torch's own count of the reference's layers, the
ROIAlign work, the trace reduction, the per-layer readers and the
comparison."""

from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import flops
import harness
import judge
from harness import BENCH, metric_reader

R101 = json.loads((BENCH / "configs" / "mask_rcnn_r101_fpn.json").read_text())
# the configuration's widths at the R50 depth
R50 = dict(R101, model=dict(R101["model"], depth=50))


def test_operation_count_by_hand():
    m = dict(R50["model"])
    # stem 7x7x3x64 at 512^2
    stem = 512 * 512 * 49 * 3 * 64
    # res2's first block at 256^2: 1x1 64->64, 3x3 64->64, 1x1 64->256,
    # shortcut 1x1 64->256
    hw = 256 * 256
    block0 = hw * (64 * 64 + 9 * 64 * 64 + 64 * 256 + 64 * 256)
    m1 = dict(m, depth=50)
    total = flops.backbone_macs(m1)
    assert total > stem + block0
    # the box head: 512 boxes x (12544 x 1024 + 1024 x 1024 + 1024 x 2
    # + 1024 x 4)
    assert flops.box_head_macs(m) == 512 * (12544 * 1024 + 1024 * 1024
                                            + 2048 + 4096)
    # the mask head: 100 x (4 x 14^2 x 9 x 256^2 + 28^2 x 256^2 + 28^2 x 256)
    assert flops.mask_head_macs(m) == 100 * (4 * 196 * 9 * 65536
                                             + 784 * 65536 + 784 * 256)
    # 0.50 TFLOP per 1024^2 R50 tile, 0.66 for R101
    assert flops.forward_flops(m) == pytest.approx(0.5006e12, rel=1e-3)
    assert flops.forward_flops(dict(m, depth=101)) == pytest.approx(
        0.6558e12, rel=1e-3)


def test_operation_count_equals_torch_count_of_the_reference():
    from torch.utils.flop_counter import FlopCounterMode

    import weights as wmod
    from reference.maskrcnn import MaskRCNN
    m = dict(R50["model"], input_size=128, rpn_post_nms_topk=16,
             max_detections=8)
    w = wmod.make_weights(m, R50["weights"], 3, torch.device("cpu"))
    ref = MaskRCNN({k: torch.from_numpy(v.astype(np.float32))
                    for k, v in _unstacked(w).items()}, m)
    x = torch.zeros((1, 3, 128, 128))
    with FlopCounterMode(display=False) as fc:
        feats = ref.backbone(x)
        ref.rpn(feats)
    assert fc.get_total_flops() == 2 * (flops.backbone_macs(m)
                                        + flops.rpn_macs(m))
    boxes = torch.tensor([[10.0, 10.0, 60.0, 50.0]] * 16)
    with FlopCounterMode(display=False) as fc:
        ref.box_head(feats, 0, boxes)
    assert fc.get_total_flops() == 2 * flops.box_head_macs(m)
    with FlopCounterMode(display=False) as fc:
        ref.mask_head(feats[:4], 0, boxes[:8])
    assert fc.get_total_flops() == 2 * flops.mask_head_macs(m)


def _unstacked(w):
    out = {}
    for k, v in w.items():
        if "_rest/block/" in k:
            stage, leaf = k.split("_rest/block/")
            for i in range(v.shape[0]):
                out[f"{stage}_{i + 1}/{leaf}"] = v[i]
        else:
            out[k] = v
    return out


def test_roi_align_work_by_hand():
    f, b = flops.roi_align_work(10, 7, 256, 2)
    assert b == 10 * 49 * 256 * 2
    assert f == 10 * 49 * 256 * 32
    assert flops.roofline_seconds(0, 3.35e12, "bfloat16") == 1.0
    assert flops.roofline_seconds(989e12, 0, "bfloat16") == 1.0


class _Ev:
    def __init__(self, name, start, dur, cuda):
        self._n, self._s, self._d, self._c = name, start, dur, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._c else DeviceType.CPU


def test_trace_summary_busy_and_gaps():
    ev = [_Ev("host_op", 0, 1000, False), _Ev("wait", 300, 500, False),
          _Ev("k1", 100, 200, True), _Ev("k2", 250, 50, True),
          _Ev("k1", 900, 100, True)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: ev)))
    s = harness.trace_summary(prof)
    assert s["window_s"] == pytest.approx(1000e-9)
    assert s["busy_s"] == pytest.approx(300e-9)       # [100, 300] + [900, 1000]
    assert s["ops"]["k1"] == pytest.approx(300e-9)
    assert s["device_ops"][0][0] == "k1"
    # gaps [0, 100] (host_op) and [300, 900] (inside "wait" only partly:
    # the innermost op spanning all of it is host_op)
    assert dict(s["idle_gaps"]) == {"host_op": pytest.approx(700e-9)}


def test_readers():
    model = R101["model"]
    rec = {"batches": 82, "batch_size": 10, "window_s": 20.0,
           "model": model, "stage_ms": [(40.0, 20.0), (42.0, 21.0),
                                        (41.0, 25.0)],
           "trace": {"busy_s": 2.0, "window_s": 8.0, "ops": {
               "void roi_pool_flat_bf16_kernel<7>": 0.01,
               "void roi_pool_flat_bf16_kernel<14>": 0.01, "gemm": 1.0}},
           "traced": {"batches": 20}}
    assert metric_reader("idle_share.stream")(rec) == 75.0
    assert metric_reader("mfu.stream")(rec) == pytest.approx(
        100 * 820 * flops.forward_flops(model) / 20.0 / 989e12)
    assert metric_reader("rpn_ms")(rec) == 41.0
    assert metric_reader("heads_ms")(rec) == 21.0
    box = 200 * 512 * 49 * 256 * 2 / 3.35e12
    mask = 200 * 100 * 196 * 256 * 2 / 3.35e12
    assert metric_reader("roi_pool_roofline")(rec) == pytest.approx(
        100 * (box + mask) / 0.02)
    empty = {"trace": {"busy_s": 0.0, "window_s": 1.0, "ops": {}}}
    for name in ("idle_share.stream", "roi_pool_roofline", "rpn_ms",
                 "heads_ms", "mfu.stream"):
        assert metric_reader(name)(empty) is None


def _tile(boxes, scores, valid=None, fill=0.5):
    boxes = np.asarray(boxes, float)
    n = len(boxes)
    return judge.TileOutput(boxes, np.asarray(scores, float),
                            np.full((n, 28, 28), fill, np.float32),
                            np.ones(n, bool) if valid is None else
                            np.asarray(valid))


def test_tile_numbers():
    out = _tile([[0, 0, 10, 10], [20, 20, 40, 40]], [0.9, 0.6])
    ref = judge.TileReference(
        det_boxes=np.array([[0, 0, 10, 10], [50, 50, 60, 60],
                            [20, 20, 40, 41], [70, 70, 80, 80]], float),
        det_scores=np.array([0.9, 0.7, 0.62, 0.4]),
        cand_boxes=np.array([[0, 0, 10, 10], [20, 20, 40, 40.5]], float),
        cand_scores=np.array([0.89, 0.62]),
        masks_on_program=np.full((2, 28, 28), 0.4, np.float32))
    n = judge.tile_numbers(out, ref)
    # the second box: 1 - IoU of the boxes grown by 1 px, 1 - 22 / 22.5
    assert n["gaps"] == pytest.approx([0.01, 1 - 22 / 22.5])
    assert n["mask"] == pytest.approx([0.1, 0.1])
    # the due reference detections, the upper half by score: the first
    # matched exactly, the second by nothing; those over 0.5 also the
    # third, within 1 - 22 / 23
    assert n["due_gaps"] == pytest.approx([0.0, 1.0])
    assert n["above_half_gaps"] == pytest.approx([0.0, 1.0, 1 - 22 / 23])
    assert (n["n"], n["n_ref"]) == (2.0, 4.0)
    s = judge.summarize([n, n])
    assert s["det_missed"] == 0.5
    assert s["det_missed_above_half"] == pytest.approx(1 / 3)
    assert s["det_gap_mean"] == pytest.approx((0.01 + 1 - 22 / 22.5) / 2)
    assert s["det_gap_max"] == pytest.approx(1 - 22 / 22.5)
    assert s["det_gap_p99"] == pytest.approx(
        np.quantile([0.01, 0.01, 1 - 22 / 22.5, 1 - 22 / 22.5], 0.99))
    assert s["det_count_gap"] == pytest.approx(0.5)
    assert judge.verdict(s, {"mask_gap": 0.1 + 1e-6}) and not judge.verdict(
        s, {"det_count_gap": 0.3})


def test_a_tile_with_nothing_valid_misses_every_due_detection():
    out = _tile([[0, 0, 10, 10]], [0.9], valid=[False])
    ref = judge.TileReference(
        det_boxes=np.array([[0, 0, 10, 10], [20, 20, 30, 30]], float),
        det_scores=np.array([0.9, 0.8]),
        cand_boxes=np.array([[0, 0, 10, 10]], float),
        cand_scores=np.array([0.9]),
        masks_on_program=np.zeros((0, 28, 28), np.float32))
    s = judge.summarize([judge.tile_numbers(out, ref)])
    assert s["det_missed"] == 1.0 and s["judged_detections"] == 0.0
