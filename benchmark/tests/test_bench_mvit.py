"""The MViTv2 cell (``mvitv2_t_tile_stream``) at a size the CPU runs in
seconds: its files are found by name, a sound run of the program is
correct, and the same run with the model broken underneath is not (the
residual pooling dropped, the windows' pad keys masked out of the softmax,
the global blocks' tables read at their stored length unresized, BGR fed
to the RGB model); the seeded weights load strictly; the operation count
against a hand count of block 0; the new readers."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

import flops
import flops_mvit
import harness
import judge
import weights_mvit
from conftest import small_copy
from harness import BENCH, metric_reader

CELL = "mvitv2_t_tile_stream"
MVIT = json.loads((BENCH / "configs" / "mask_rcnn_mvitv2_t.json")
                  .read_text())
# 128 px input, width 16, 5 blocks (stages end at 0, 2, 3, 4), window 12,
# pretraining 96 px: block 0's 32 x 32 map pads to 36 (its 8 x 8 keys to
# 9), block 1 pools q 2x and doubles the width, block 2's global tables
# are resized from 23 rows to 31
TINY = dict(input_size=128, mvit_embed_dim=16, mvit_depth=5,
            mvit_num_heads=1, mvit_last_block_indexes=[0, 2, 3, 4],
            mvit_adaptive_window_size=12, mvit_pretrain_size=96)


def small_mvit_copy(dst: Path) -> Path:
    """``small_copy`` with the MViTv2 configuration cut to :data:`TINY`,
    and its stream to 8 tiles."""
    root = small_copy(dst)
    bench = root / "benchmark"
    path = bench / "configs" / "mask_rcnn_mvitv2_t.json"
    c = json.loads(path.read_text())
    c["model"].update(TINY)
    c["program"].update({("model_input_size" if k == "input_size" else k): v
                         for k, v in TINY.items()})
    path.write_text(json.dumps(c))
    path = bench / "workloads" / f"{CELL}.json"
    t = json.loads(path.read_text())
    t["traffic_params"].update(sheet_px=1000, tiles=8, judged_batches=2,
                               traced_batches=1, marked_batches=1)
    path.write_text(json.dumps(t))
    return root


# -- planted faults -----------------------------------------------------------

def _residual_dropped(monkeypatch, state):
    from treedetection_tpu_torch.models import mvit
    attend = mvit.pooled_attention

    def without_q(q, k, v, rh, rw, heads, qw, kw):
        out = attend(q, k, v, rh, rw, heads, qw, kw)
        n, h, w, d = q.shape
        return out - q.reshape(n // heads, heads, h, w, d).permute(
            0, 2, 3, 1, 4).reshape(out.shape)

    monkeypatch.setattr(mvit, "pooled_attention", without_q)


def _masked_pads(q, k, v, rel_h, rel_w, num_heads, q_window, kv_window):
    """The attention with the windows' pad keys masked out of the softmax
    (detectron2 keeps them)."""
    from treedetection_tpu_torch.ops.kernels.relpos_attention import (
        _partition, pooled_attention_reference, pooled_rel_index)
    if not q_window:
        return pooled_attention_reference(q, k, v, rel_h, rel_w, num_heads,
                                          q_window, kv_window)
    n, hq, wq, d = q.shape
    qs, ks = q_window, kv_window
    qw = _partition(q.float(), qs, qs)
    kw = _partition(k.float(), ks, ks)
    vw = _partition(v.float(), ks, ks)
    real = _partition(torch.ones(n, *k.shape[1:3], 1), ks, ks)[..., 0] > 0
    rh = rel_h.float()[pooled_rel_index(qs, ks)]
    rw = rel_w.float()[pooled_rel_index(qs, ks)]
    rq = qw.reshape(-1, qs, qs, d)
    logits = ((qw * d ** -0.5) @ kw.transpose(-1, -2)).reshape(
        -1, qs, qs, ks, ks) + torch.einsum(
        "nhwc,hkc->nhwk", rq, rh)[..., :, None] + torch.einsum(
        "nhwc,wkc->nhwk", rq, rw)[..., None, :]
    logits = logits.reshape(-1, qs * qs, ks * ks).masked_fill(
        ~real[:, None, :], float("-inf"))
    out = torch.softmax(logits, dim=-1) @ vw
    nh, nw = -(-hq // qs), -(-wq // qs)
    out = out.reshape(n, nh, nw, qs, qs, d).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(n, nh * qs, nw * qs, d)[:, :hq, :wq] + q.float()
    out = out.reshape(n // num_heads, num_heads, hq, wq, d).permute(
        0, 2, 3, 1, 4).reshape(n // num_heads, hq, wq, num_heads * d)
    return out.to(q.dtype)


def _pads_masked(monkeypatch, state):
    from treedetection_tpu_torch.models import mvit
    monkeypatch.setattr(mvit, "pooled_attention", _masked_pads)


def _tables_unresized(monkeypatch, state):
    """The global blocks read their stored tables' rows where the resized
    rows belong (zeros past the stored length)."""
    for block in state["pred"].model.backbone.bottom_up.blocks:
        attn = block.attn
        if block.window:
            continue
        for stored, name in ((attn.rel_pos_h, "rel_h_used"),
                             (attn.rel_pos_w, "rel_w_used")):
            used = getattr(attn, name)
            flat = torch.zeros_like(used)
            rows = min(stored.shape[0], used.shape[0])
            flat[:rows] = stored[:rows].to(used.dtype)
            monkeypatch.setattr(attn, name, flat)


def _bgr_fed(monkeypatch, state):
    from treedetection_tpu_torch import prediction
    normalize = prediction.normalize_image
    monkeypatch.setattr(prediction, "normalize_image",
                        lambda rgb, mean, std, fmt: normalize(rgb, mean, std,
                                                              "BGR"))


FAULTS = {"residual_pooling_dropped": _residual_dropped,
          "pad_keys_masked": _pads_masked,
          "global_tables_unresized": _tables_unresized,
          "bgr_into_rgb_model": _bgr_fed}


@pytest.fixture(scope="module")
def sound_state(tmp_path_factory):
    torch.set_num_threads(4)
    cell = harness.Cell(CELL, small_mvit_copy(
        tmp_path_factory.mktemp("bench")))
    drv = cell.driver()
    state = drv.setup(cell, 2 ** 32 + 23)
    yield drv, state
    drv.close(state)


def test_the_cell_is_found_by_name(sound_state):
    drv, state = sound_state
    cell = state["cell"]
    assert drv.__name__ == "traffic.tile_stream_mvit"
    assert cell.model["backbone"] == "mvit"
    assert [m["name"] for m in cell.end_to_end] == [
        "tiles_per_s", "batch_ms_p95", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "pooled_attn_roofline", "pooled_attn_ms", "mfu.mvit_stream",
        "idle_share.mvit_stream", "rpn_ms.mvit_served",
        "heads_ms.mvit_served"}
    assert state["pred"].cfg.backbone == "mvit"


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
    FAULTS[fault](monkeypatch, state)
    drv.window(state, 0.5)
    numbers, limits = drv.judge(state)
    assert not judge.verdict(numbers, limits), (fault, numbers)


def test_seeded_weights_load_strictly():
    """Every leaf of ``weights_mvit`` is a parameter of the port's model and
    the other way round, at the published widths."""
    from treedetection_tpu_torch.models.convert import from_flax_params
    from treedetection_tpu_torch.models.mask_rcnn import (
        MaskRCNN, MaskRCNNConfig)
    m = MVIT["model"]
    tree = {}
    for key, shape, _ in weights_mvit.leaves(m):
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.zeros(shape).numpy()
    sd = from_flax_params(tree)
    model = MaskRCNN(MaskRCNNConfig(backbone="mvit", rpn_post_nms_topk=512))
    want = model.state_dict()
    assert set(sd) == set(want)
    assert all(tuple(sd[k].shape) == tuple(want[k].shape) for k in sd)
    model.load_state_dict(sd, strict=True)
    # 43.25 M parameters, as published for MViTv2-T Mask R-CNN
    assert sum(v.numel() for v in sd.values()) == 43_254_390


# -- the operation count ------------------------------------------------------

def test_block_0_by_hand():
    """Block 0: a 256 x 256 map of 96 channels (1024 / 4), q at stride 1 in
    56 x 56 windows, k and v pooled 4x to 64 x 64 in 14 x 14 windows."""
    m = MVIT["model"]
    n, nk = 256 * 256, 64 * 64
    attention = n * 96 * (2 * 196 + 2 * 14)
    assert flops_mvit.attention_macs(m, 0) == attention
    qkv = n * 96 * 288
    pools = 9 * 96 * (n + 2 * nk)
    proj = n * 96 * 96
    mlp = 2 * n * 96 * 384
    patch = n * 49 * 3 * 96
    block0 = flops_mvit.mvit_macs(dict(m, mvit_depth=1,
                                       mvit_last_block_indexes=[0]))
    assert block0 == patch + qkv + pools + attention + proj + mlp
    ops, nbytes = flops_mvit.attention_work(m, 10)[0]
    assert ops == 2 * 10 * attention
    # q and the output of 10 maps, k and v of 10 pooled maps, two tables
    # of 111 rows
    assert nbytes == 2 * (10 * 96 * (2 * n + 2 * nk) + 2 * 111 * 96)
    assert flops_mvit.attention_launches(m) == {"window": 7, "global": 3}
    # 0.54 TFLOP a 1024^2 tile, 0.048 of it the attention
    assert flops_mvit.forward_flops(m) == pytest.approx(5.439e11, rel=1e-3)
    assert sum(2 * flops_mvit.attention_macs(m, i) for i in range(10)) == \
        pytest.approx(4.849e10, rel=1e-3)


def test_the_new_readers():
    m = MVIT["model"]
    trace = {"busy_s": 1.5, "window_s": 2.0,
             "ops": {"(anonymous namespace)::relpos_attention_kernel_pooled("
                     "(anonymous namespace)::PooledParams)": 0.1,
                     "ampere_bf16_gemm": 1.0}}
    records = {"trace": trace, "traced": {"batches": 20, "span_s": 2.0},
               "model": m, "batch_size": 10, "batches": 100,
               "window_s": 10.0}
    least = sum(flops.roofline_seconds(o, b, "bfloat16")
                for o, b in flops_mvit.attention_work(m, 10))
    assert metric_reader("pooled_attn_roofline")(records) == pytest.approx(
        100 * 20 * least / 0.1)
    assert metric_reader("pooled_attn_ms")(records) == pytest.approx(5.0)
    assert metric_reader("mfu.mvit_stream")(records) == pytest.approx(
        100 * 100 * 10 * flops_mvit.forward_flops(m) / 10.0 / 989e12)
    assert metric_reader("idle_share.mvit_stream")(records) == \
        pytest.approx(25.0)
    # a program without the kernel (ViTDet's kernel alone): nothing to
    # read, nothing raised
    bare = dict(records, trace=dict(trace, ops={
        "relpos_attention_kernel_stream": 1.0}))
    assert metric_reader("pooled_attn_roofline")(bare) is None
    assert metric_reader("pooled_attn_ms")(bare) is None
