"""The ViTDet cell (``vitdet_l_tile_stream``) at a size the CPU runs in
seconds: its files are found by name, a sound run of the program is
correct, and the same run with the model broken underneath is not (the
relative-position bias dropped, the windows' pad keys masked out of the
softmax, BGR fed to the RGB model); without a card the run prints no
result; the operation count against a hand count; the new readers."""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import flops
import flops_vitdet
import harness
import judge
from conftest import small_copy
from harness import BENCH, ROOT, metric_reader

CELL = "vitdet_l_tile_stream"
VITDET = json.loads((BENCH / "configs" / "mask_rcnn_vitdet_l.json")
                    .read_text())


def small_vitdet_copy(dst: Path) -> Path:
    """``small_copy`` with the ViTDet configuration cut to a 128 px input,
    width 64, 4 blocks (1 and 3 global), 4 heads and window 3, and its
    stream to 8 tiles."""
    root = small_copy(dst)
    bench = root / "benchmark"
    path = bench / "configs" / "mask_rcnn_vitdet_l.json"
    c = json.loads(path.read_text())
    c["model"].update(input_size=128, vit_dim=64, vit_depth=4, vit_heads=4,
                      vit_window=3, vit_global_blocks=[1, 3])
    c["program"].update(model_input_size=128, vit_embed_dim=64, vit_depth=4,
                        vit_num_heads=4, vit_window_size=3,
                        vit_global_blocks=[1, 3])
    path.write_text(json.dumps(c))
    path = bench / "workloads" / f"{CELL}.json"
    t = json.loads(path.read_text())
    t["traffic_params"].update(sheet_px=1000, tiles=8, judged_batches=2,
                               traced_batches=1, marked_batches=1)
    path.write_text(json.dumps(t))
    return root


# -- planted faults -----------------------------------------------------------

def _bias_dropped(monkeypatch):
    from treedetection_tpu_torch.models import vit
    attend = vit.relpos_attention
    monkeypatch.setattr(vit, "relpos_attention",
                        lambda qkv, bias, rh, rw, heads, window: attend(
                            qkv, bias, rh * 0, rw * 0, heads, window))


def _masked_pads(qkv, bias, rel_h, rel_w, num_heads, window):
    """The attention with the windows' pad keys masked out of the softmax
    (detectron2 keeps them)."""
    from treedetection_tpu_torch.ops.kernels.relpos_attention import (
        rel_index, relpos_attention_reference)
    if not window:
        return relpos_attention_reference(qkv, bias, rel_h, rel_w, num_heads,
                                          window)
    b, h, w, c3 = qkv.shape
    c, s = c3 // 3, window
    d = c // num_heads
    hp, wp = -(-h // s) * s, -(-w // s) * s
    x = bias.float().expand(b, hp, wp, c3).clone()
    x[:, :h, :w] = qkv.float()
    real = torch.zeros(b, hp, wp, dtype=torch.bool)
    real[:, :h, :w] = True
    nh, nw = hp // s, wp // s
    x = x.reshape(b, nh, s, nw, s, 3, num_heads, d).permute(
        5, 0, 1, 3, 6, 2, 4, 7).reshape(3, -1, num_heads, s * s, d)
    real = real.reshape(b, nh, s, nw, s).permute(0, 1, 3, 2, 4).reshape(
        -1, 1, 1, s * s)
    q, k, v = x[0], x[1], x[2]
    idx = rel_index(s)
    qq = q.reshape(-1, num_heads, s, s, d)
    bh = torch.einsum("nhyxd,ykd->nhyxk", qq, rel_h.float()[idx])
    bw = torch.einsum("nhyxd,xkd->nhyxk", qq, rel_w.float()[idx])
    logits = ((q * d ** -0.5) @ k.transpose(-1, -2)).reshape(
        -1, num_heads, s, s, s, s) + bh[..., :, None] + bw[..., None, :]
    logits = logits.reshape(-1, num_heads, s * s, s * s).masked_fill(
        ~real, float("-inf"))
    out = torch.softmax(logits, dim=-1) @ v
    out = out.reshape(b, nh, nw, num_heads, s, s, d).permute(
        0, 1, 4, 2, 5, 3, 6).reshape(b, hp, wp, c)
    return out[:, :h, :w].to(qkv.dtype)


def _pads_masked(monkeypatch):
    from treedetection_tpu_torch.models import vit
    monkeypatch.setattr(vit, "relpos_attention", _masked_pads)


def _bgr_fed(monkeypatch):
    from treedetection_tpu_torch import prediction
    normalize = prediction.normalize_image
    monkeypatch.setattr(prediction, "normalize_image",
                        lambda rgb, mean, std, fmt: normalize(rgb, mean, std,
                                                              "BGR"))


FAULTS = {"relpos_bias_dropped": _bias_dropped,
          "pad_keys_masked": _pads_masked, "bgr_into_rgb_model": _bgr_fed}


@pytest.fixture(scope="module")
def sound_state(tmp_path_factory):
    torch.set_num_threads(4)
    cell = harness.Cell(CELL, small_vitdet_copy(
        tmp_path_factory.mktemp("bench")))
    drv = cell.driver()
    state = drv.setup(cell, 2 ** 32 + 17)
    yield drv, state
    drv.close(state)


def test_the_cell_is_found_by_name(sound_state):
    drv, state = sound_state
    cell = state["cell"]
    assert drv.__name__ == "traffic.tile_stream_vitdet"
    assert cell.model["backbone"] == "vit"
    assert [m["name"] for m in cell.end_to_end] == [
        "tiles_per_s", "batch_ms_p95", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "relpos_attn_roofline", "relpos_attn_ms", "mfu.vitdet_stream",
        "idle_share.vitdet_stream", "rpn_ms.vitdet_served",
        "heads_ms.vitdet_served"}
    assert state["pred"].cfg.backbone == "vit"


def test_a_sound_run_is_correct(sound_state):
    drv, state = sound_state
    win = drv.window(state, 0.5)
    assert win["failed"] == 0 and win["attempted"] > 0
    numbers, limits = drv.judge(state)
    assert numbers["judged_detections"] > 0 and numbers["due_detections"] > 0
    assert judge.verdict(numbers, limits), numbers


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_run_is_not_correct(sound_state, fault, monkeypatch):
    drv, state = sound_state
    FAULTS[fault](monkeypatch)
    drv.window(state, 0.5)
    numbers, limits = drv.judge(state)
    assert not judge.verdict(numbers, limits), (fault, numbers)


def test_without_a_card_the_run_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", CELL,
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


# -- the operation count ------------------------------------------------------

def test_operation_count_by_hand():
    m = VITDET["model"]
    n = 64 * 64
    # one block's projections: qkv 1024 -> 3072, proj, MLP 1024 -> 4096 ->
    # 1024, for every token of the map
    proj = n * (1024 * 3072 + 1024 * 1024 + 2 * 1024 * 4096)
    # a windowed block's attention: 16 heads x 64 = 1024 channels, each
    # real query against 196 keys twice and 14 + 14 table rows; a global
    # block's against 4096 keys and 64 + 64 rows
    window = n * 1024 * (2 * 196 + 28)
    glob = n * 1024 * (2 * 4096 + 128)
    assert flops_vitdet.attention_macs(m, 14, 14) == window
    assert flops_vitdet.attention_macs(m, 64, 64) == glob
    patch = n * 16 * 16 * 3 * 1024
    assert flops_vitdet.vit_macs(m) == patch + 24 * proj + 20 * window \
        + 4 * glob
    # the pyramid: deconvs to 128^2 (1024 -> 512, twice: P2 and P3's
    # branches) and 256^2 (512 -> 256); per level a 1x1 to 256 and a 3x3
    pyr = 2 * 128 ** 2 * 1024 * 512 + 256 ** 2 * 512 * 256
    for hw, cin in ((256, 256), (128, 512), (64, 1024), (32, 1024)):
        pyr += hw * hw * cin * 256 + hw * hw * 9 * 256 * 256
    assert flops_vitdet.pyramid_macs(m) == pyr
    # the box head: 512 proposals x (4 convs 3x3 256 at 7x7 + FC 12544 ->
    # 1024 + the two predictors)
    assert flops_vitdet.box_head_macs(m) == 512 * (
        4 * 49 * 9 * 65536 + 12544 * 1024 + 1024 * 2 + 1024 * 4)
    # two RPN convs on P2-P6
    cells = sum(math.ceil(1024 / s) ** 2 for s in (4, 8, 16, 32, 64))
    assert flops_vitdet.rpn_macs(m) == cells * (2 * 9 * 65536 + 256 * 3
                                                + 256 * 12)
    assert flops_vitdet.forward_flops(m) == 2 * (
        flops_vitdet.vit_macs(m) + pyr + flops_vitdet.rpn_macs(m)
        + flops_vitdet.box_head_macs(m) + flops.mask_head_macs(m))
    # 3.44 TFLOP a 1024^2 tile, 2.83 of it the ViT
    assert flops_vitdet.forward_flops(m) == pytest.approx(3.4407e12, rel=1e-3)
    assert 2 * flops_vitdet.vit_macs(m) == pytest.approx(2.830e12, rel=1e-3)


def test_attention_work_by_hand():
    m = VITDET["model"]
    work = flops_vitdet.attention_work(m, 10)
    assert work["global"][0] == 2 * 10 * 4096 * 1024 * (2 * 4096 + 128)
    # q, k, v and the output of 10 maps, the bias, tables of 127 rows
    assert work["global"][1] == 2 * (10 * 4096 * 4 * 1024 + 3072
                                     + 2 * 127 * 64)
    assert work["window"][1] == 2 * (10 * 4096 * 4 * 1024 + 3072
                                     + 2 * 27 * 64)
    assert flops_vitdet.attention_launches(m) == {"window": 20, "global": 4}
    # the global blocks are bound by operations, the windowed by bytes
    g_ops, g_bytes = work["global"]
    w_ops, w_bytes = work["window"]
    peaks = flops.PEAKS
    assert g_ops / peaks["flops_per_s"]["bfloat16"] > \
        g_bytes / peaks["hbm_bytes_per_s"]
    assert w_ops / peaks["flops_per_s"]["bfloat16"] < \
        w_bytes / peaks["hbm_bytes_per_s"]


def test_the_new_readers():
    m = VITDET["model"]
    trace = {"busy_s": 1.5, "window_s": 2.0,
             "ops": {"(anonymous namespace)::relpos_attention_kernel("
                     "(anonymous namespace)::Params)": 0.2,
                     "ampere_bf16_gemm": 1.0}}
    records = {"trace": trace, "traced": {"batches": 20, "span_s": 2.0},
               "model": m, "batch_size": 10, "batches": 100,
               "window_s": 10.0}
    work = flops_vitdet.attention_work(m, 10)
    least = 20 * (20 * flops.roofline_seconds(*work["window"], "bfloat16")
                  + 4 * flops.roofline_seconds(*work["global"], "bfloat16"))
    assert metric_reader("relpos_attn_roofline")(records) == pytest.approx(
        100 * least / 0.2)
    assert metric_reader("relpos_attn_ms")(records) == pytest.approx(10.0)
    assert metric_reader("mfu.vitdet_stream")(records) == pytest.approx(
        100 * 100 * 10 * flops_vitdet.forward_flops(m) / 10.0 / 989e12)
    assert metric_reader("idle_share.vitdet_stream")(records) == \
        pytest.approx(25.0)
    # a program without the kernel: nothing to read, nothing raised
    bare = dict(records, trace=dict(trace, ops={"gemm": 1.0}))
    assert metric_reader("relpos_attn_roofline")(bare) is None
    assert metric_reader("relpos_attn_ms")(bare) is None
