"""Mask R-CNN MViTv2 in the port (``models/mvit.py``, the pooled attention's
plain version in ``ops/kernels/relpos_attention.py``, the R-FPN heads)
against the benchmark's float32 reference (``benchmark/reference/mvit.py``)
on seeded weights from ``benchmark/weights_mvit.py``, at a tiny size on the
CPU: 128 input, width 16, 5 blocks with stages ending at blocks 0, 2, 3
and 4, window 12, pretraining size 96, so that block 0's 32 x 32 map pads
to 36 (its 8 x 8 keys to 9), block 1 pools q 2x and doubles the width, and
block 2's global tables are resized from 23 rows to 31.  Also the pooled
attention's plain version against detectron2's computation at q/kv ratios
4, 2, 1 and 1/2 with pad keys and resized tables, the loaders (the Flax
layout strictly, detectron2's MViT key names), the ``mvit_*`` config keys
and the one place that builds the model configuration from the spec."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
BENCH = REPO / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import weights as bench_weights  # noqa: E402
import weights_mvit  # noqa: E402
from frozen.synthetic import make_sheet  # noqa: E402
from reference.maskrcnn import tensors  # noqa: E402
from reference.mvit import (  # noqa: E402
    MViT, attend, window_partition, window_unpartition)

from treedetection_tpu_torch.config import (  # noqa: E402
    Config, ModelSpec, model_spec, prepare_config)
from treedetection_tpu_torch.models import mvit as port_mvit  # noqa: E402
from treedetection_tpu_torch.models.convert import (  # noqa: E402
    convert_detectron2_state_dict, load_checkpoint)
from treedetection_tpu_torch.models.mask_rcnn import (  # noqa: E402
    MaskRCNN, MaskRCNNConfig, config_from_spec)
from treedetection_tpu_torch.ops.kernels.relpos_attention import (  # noqa
    pooled_attention, pooled_attention_reference, resize_table, table_rows)
from treedetection_tpu_torch.prediction import Predictor  # noqa: E402

CONFIG = json.loads((BENCH / "configs" / "mask_rcnn_mvitv2_t.json")
                    .read_text())
WIDTHS = dict(mvit_embed_dim=16, mvit_depth=5, mvit_num_heads=1,
              mvit_last_block_indexes=[0, 2, 3, 4],
              mvit_adaptive_window_size=12, mvit_pretrain_size=96)
TINY = dict(CONFIG["model"], input_size=128, rpn_pre_nms_topk=200,
            rpn_post_nms_topk=64, max_detections=20, **WIDTHS)
TINY_PROGRAM = dict(CONFIG["program"], model_input_size=128,
                    rpn_pre_nms_topk=200, rpn_post_nms_topk=64,
                    max_detections=20, batch_size=2, mixed_precision=False,
                    **WIDTHS)
PAD = 100          # tiles resized 100 -> 128, as the cell resizes 456 -> 1024


def tiny_cfg(**over) -> MaskRCNNConfig:
    widths = {k: tuple(v) if isinstance(v, list) else v
              for k, v in WIDTHS.items()}
    return MaskRCNNConfig(backbone="mvit", input_size=128,
                          rpn_pre_nms_topk=200, rpn_post_nms_topk=64,
                          max_detections=20, **widths, **over)


def _tiles(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rgbi, _ = make_sheet(400, 60, seed)
    ys = rng.integers(0, 400 - PAD, n)
    xs = rng.integers(0, 400 - PAD, n)
    return np.stack([rgbi[y:y + PAD, x:x + PAD, :3] for y, x in zip(ys, xs)])


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """The tiny model's seeded, calibrated weights in one ``.npz``, and the
    tiles they were calibrated on."""
    torch.manual_seed(0)
    tiles = _tiles(4, 5)
    w = weights_mvit.make_weights(TINY, CONFIG["weights"], 2 ** 32 + 11,
                                  torch.device("cpu"))
    weights_mvit.calibrate(w, TINY, CONFIG["weights"], tiles,
                           torch.device("cpu"))
    path = tmp_path_factory.mktemp("mvit") / "weights.npz"
    bench_weights.write_weights(str(path), w)
    return path, w, tiles


def _port(path) -> MaskRCNN:
    model = MaskRCNN(tiny_cfg())
    model.load_state_dict(load_checkpoint(str(path)), strict=True)
    return model.eval()


def _reference(w) -> MViT:
    return MViT(tensors(w, torch.device("cpu")), TINY)


# -- the pooled attention -----------------------------------------------------

def detectron2_attention(q, k, v, rel_h, rel_w, heads, q_window,
                         kv_window):
    """``MultiScaleAttention.forward`` between the pooling and the output
    projection, from the benchmark reference's pieces: windows partitioned
    with zero pads, ``get_rel_pos`` resizing the stored tables itself, the
    windows put back, q added, heads concatenated."""
    n, _, _, d = q.shape
    ori_q = q
    if q_window:
        q, q_pad = window_partition(q, q_window)
        k, _ = window_partition(k, kv_window)
        v, _ = window_partition(v, kv_window)
        q_hw, kv_hw = (q_window,) * 2, (kv_window,) * 2
    else:
        q_hw, kv_hw = tuple(q.shape[1:3]), tuple(k.shape[1:3])
    m = q.shape[0]
    out = attend(q.reshape(m, -1, d), k.reshape(m, -1, d),
                 v.reshape(m, -1, d), rel_h, rel_w, q_hw, kv_hw)
    out = out.reshape(m, q_hw[0], q_hw[1], d)
    if q_window:
        out = window_unpartition(out, q_window, q_pad, ori_q.shape[1:3])
    out = out + ori_q
    hq, wq = out.shape[1:3]
    return out.reshape(n // heads, heads, hq, wq, d).permute(
        0, 2, 3, 1, 4).reshape(n // heads, hq, wq, heads * d)


# (heads, batch, q map, kv map, q window, kv window (0, 0: global), stored
# table rows): q/kv side ratios 4, 2, 1 and 1/2, maps that pad to their
# windows, tables at other lengths than the rows they are read at
POOLED_CASES = {
    "windowed_ratio_4_pads": (1, 2, 12, 3, 8, 2, 9),
    "windowed_ratio_2": (2, 1, 8, 4, 4, 2, 7),
    "windowed_ratio_1_pads": (2, 2, 7, 7, 3, 3, 5),
    "windowed_ratio_half_pads": (4, 1, 5, 10, 2, 4, 7),
    "global_ratio_4_resized": (2, 2, 8, 2, 0, 0, 7),
    "global_ratio_half_resized": (1, 2, 3, 6, 0, 0, 5),
    "global_ratio_1_resized": (2, 1, 4, 4, 0, 0, 13),
}


@pytest.mark.parametrize("case", POOLED_CASES)
def test_pooled_attention_plain_version_matches_detectron2(case):
    heads, b, hq, hk, qw, kw, stored = POOLED_CASES[case]
    d = 8
    gen = torch.Generator().manual_seed(len(case))
    q = torch.randn(b * heads, hq, hq, d, generator=gen)
    k = torch.randn(b * heads, hk, hk, d, generator=gen)
    v = torch.randn(b * heads, hk, hk, d, generator=gen)
    rh = torch.randn(stored, d, generator=gen)
    rw = torch.randn(stored, d, generator=gen)
    want = detectron2_attention(q, k, v, rh, rw, heads, qw, kw)
    sq, sk = qw or hq, kw or hk
    rows = table_rows(sq, sk)
    got = pooled_attention(q, k, v, resize_table(rh, rows),
                           resize_table(rw, rows), heads, qw, kw)
    assert got.shape == (b, hq, hq, heads * d)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_pooled_attention_pads_and_bias_matter():
    """A map padded to its windows takes part with zero keys and values:
    the same as padding it with zeros by hand, and unlike padding it with
    anything else; each bias term moves the output."""
    gen = torch.Generator().manual_seed(2)
    q = torch.randn(2, 10, 10, 8, generator=gen) * 2
    k = torch.randn(2, 5, 5, 8, generator=gen) * 2
    v = torch.randn(2, 5, 5, 8, generator=gen)
    rh = torch.randn(table_rows(4, 2), 8, generator=gen)
    rw = torch.randn(table_rows(4, 2), 8, generator=gen)
    base = pooled_attention_reference(q, k, v, rh, rw, 2, 4, 2)

    def padded(t, side, value):
        return torch.nn.functional.pad(t, (0, 0, 0, side - t.shape[2], 0,
                                           side - t.shape[1]), value=value)

    zeros = pooled_attention_reference(
        padded(q, 12, 0.0), padded(k, 6, 0.0), padded(v, 6, 0.0), rh, rw,
        2, 4, 2)[:, :10, :10]
    torch.testing.assert_close(zeros, base, rtol=1e-5, atol=1e-5)
    ones = pooled_attention_reference(
        padded(q, 12, 0.0), padded(k, 6, 1.0), padded(v, 6, 1.0), rh, rw,
        2, 4, 2)[:, :10, :10]
    # the windows of the last row and column hold pad keys, the others none
    assert (ones - base)[:, 8:, 8:].abs().max() > 1e-2
    torch.testing.assert_close(ones[:, :8, :8], base[:, :8, :8])
    for other in (pooled_attention_reference(q, k, v, rh * 0, rw, 2, 4, 2),
                  pooled_attention_reference(q, k, v, rh, rw * 0, 2, 4, 2)):
        assert (other - base).abs().max() > 1e-2


def test_pooled_attention_refuses_what_it_does_not_take():
    q, kv = torch.zeros(2, 8, 8, 8), torch.zeros(2, 4, 4, 8)
    rows = table_rows(4, 2)
    with pytest.raises(ValueError):     # tables at the wrong length
        pooled_attention(q, kv, kv, torch.zeros(rows + 2, 8),
                         torch.zeros(rows, 8), 1, 4, 2)
    with pytest.raises(ValueError):     # window grids that differ
        pooled_attention(q, kv, kv, torch.zeros(rows, 8),
                         torch.zeros(rows, 8), 1, 4, 1)
    with pytest.raises(ValueError):     # one side windowed
        pooled_attention(q, kv, kv, torch.zeros(15, 8),
                         torch.zeros(15, 8), 1, 4, 0)
    with pytest.raises(ValueError):     # maps that are not of 3 heads
        pooled_attention(q, kv, kv, torch.zeros(rows, 8),
                         torch.zeros(rows, 8), 3, 4, 2)


# -- the backbone and the model -----------------------------------------------

def test_seeded_weights_load_strictly(seeded):
    path, w, _ = seeded
    sd = load_checkpoint(str(path))
    model = MaskRCNN(tiny_cfg())
    missing = set(model.state_dict()) ^ set(sd)
    assert not missing, sorted(missing)[:10]
    model.load_state_dict(sd, strict=True)
    assert len(weights_mvit.leaves(TINY)) == len(sd) == len(w)
    # each block's tables at the rows it reads are set at load, resized
    # where the checkpoint's length differs (block 2: 23 -> 31 rows)
    blocks = model.backbone.bottom_up.blocks
    attn = blocks[2].attn
    assert tuple(attn.rel_pos_h.shape) == (23, 16)
    assert tuple(attn.rel_h_used.shape) == (31, 16)
    torch.testing.assert_close(attn.rel_h_used,
                               resize_table(attn.rel_pos_h, 31))
    assert blocks[1].attn.rel_w_used.abs().max() > 0


def test_tables_are_not_resized_in_the_forward(seeded, monkeypatch):
    path, _, _ = seeded
    model = _port(path)

    def refuse(*args):
        raise AssertionError("resize_table called in the forward")

    monkeypatch.setattr(port_mvit, "resize_table", refuse)
    with torch.no_grad():
        model.backbone(torch.zeros(1, 128, 128, 3))


def test_backbone_levels_match_the_reference(seeded):
    path, w, _ = seeded
    model, ref = _port(path), _reference(w)
    x = torch.randn(2, 128, 128, 3, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = model.backbone(x)
        want = ref.backbone(x.permute(0, 3, 1, 2))
    assert [tuple(g.shape) for g in got] == [
        (2, 32, 32, 256), (2, 16, 16, 256), (2, 8, 8, 256), (2, 4, 4, 256),
        (2, 2, 2, 256)]
    for g, r in zip(got, want):
        r = r.permute(0, 2, 3, 1)
        scale = float(r.abs().max())
        assert float((g - r).abs().max()) < 1e-4 * scale


def _predictor(tmp_path, weights_path, **over) -> Predictor:
    raw = dict(TINY_PROGRAM, device="cpu", image_directory=str(tmp_path),
               height_data_path=str(tmp_path),
               output_directory=str(tmp_path / "out"),
               tiles_path=str(tmp_path / "tiles"),
               combined_model=str(weights_path), compile_warmup=False,
               **over)
    Config.reset()
    config, _ = prepare_config(raw, str(tmp_path))
    pred = Predictor(config, str(weights_path))
    for handler in list(config["logger"].handlers):
        config["logger"].removeHandler(handler)
        handler.close()
    return pred


def test_predictor_detections_match_the_reference(seeded, tmp_path):
    """The whole model through the Predictor (RGB input, resize, the MViT,
    the FPN, the R-FPN heads) to detections, against the reference's, at
    ``tests/test_oracle.py``'s tolerances."""
    path, w, tiles = seeded
    pred = _predictor(tmp_path, path)
    assert not pred.used_random_init
    assert pred.cfg.backbone == "mvit" and pred.spec.input_format == "RGB"
    assert pred.cfg.mvit_last_block_indexes == (0, 2, 3, 4)
    forward, _ = pred._get_forward(PAD)
    out = forward(np.ascontiguousarray(tiles[:2]))[0][0]
    ref = _reference(w)
    with torch.no_grad():
        feats, rpn = ref.features(torch.from_numpy(tiles[:2]))
        for j in range(2):
            det = ref.detect(feats, rpn, j, cut=True)
            nv = int(out.valid[j].sum())
            assert nv == len(det.scores) and nv > 0
            boxes = out.boxes[j][:nv].numpy()
            assert np.abs(boxes - det.boxes.numpy()).max() < 1e-3
            assert np.abs(out.scores[j][:nv].numpy()
                          - det.scores.numpy()).max() < 1e-4
            masks = out.masks[j][:nv].numpy().astype(np.float32) / 255.0
            assert np.abs(masks - det.masks.numpy()).max() < 0.02


# -- the configuration --------------------------------------------------------

def test_mvit_keys_select_the_model():
    spec = model_spec({"model_backbone": "mvit", "mvit_depth": 5,
                       "mvit_last_block_indexes": [0, 2, 3, 4],
                       "mvit_adaptive_window_size": 12,
                       "mvit_pretrain_size": 96, "mvit_embed_dim": 16})
    cfg = config_from_spec(spec)
    assert (cfg.backbone, cfg.mvit_depth, cfg.mvit_last_block_indexes,
            cfg.mvit_adaptive_window_size, cfg.mvit_pretrain_size,
            cfg.mvit_embed_dim) == ("mvit", 5, (0, 2, 3, 4), 12, 96, 16)
    # the published MViTv2-T by default, with the R-FPN heads
    model = MaskRCNN(config_from_spec(model_spec({"model_backbone":
                                                  "mvit"})))
    blocks = model.backbone.bottom_up.blocks
    assert len(blocks) == 10
    assert [b.window for b in blocks] == [56, 56, 0, 28, 14, 14, 14, 0, 14,
                                          0]
    assert [(b.attn.q_window, b.attn.kv_window) for b in blocks] == [
        (56, 14), (28, 28), (0, 0), (14, 28), (14, 14), (14, 14), (14, 14),
        (0, 0), (7, 14), (0, 0)]
    assert [b.attn.rel_h_used.shape[0] for b in blocks] == [
        111, 55, 255, 55, 27, 27, 27, 127, 27, 63]
    assert [b.attn.rel_pos_h.shape[0] for b in blocks] == [
        111, 55, 55, 55, 27, 27, 27, 27, 27, 13]
    assert isinstance(model.rpn_head.conv, torch.nn.Conv2d)
    assert model.box_head.num_convs == 0 and hasattr(model.box_head, "fc2")
    assert sum(p.numel() for p in model.parameters()) == 43_254_390


def test_the_spec_builds_the_model_configuration_in_one_place():
    """``config_from_spec`` gives what the Predictor built field by field
    before it, for each backbone, and every width of the spec reaches the
    configuration by name."""
    for raw in ({}, {"model_backbone": "vit", "vit_window_size": 7},
                {"model_backbone": "mvit", "rpn_post_nms_topk": 512}):
        spec = model_spec(raw)
        want = MaskRCNNConfig(
            depth=spec.depth, num_classes=spec.num_classes,
            input_size=spec.input_size, score_threshold=spec.score_threshold,
            nms_threshold=spec.nms_threshold,
            rpn_pre_nms_topk=spec.pre_nms_topk,
            rpn_post_nms_topk=spec.post_nms_topk,
            rpn_nms_threshold=spec.rpn_nms_threshold,
            max_detections=spec.max_detections,
            mask_pool=spec.mask_resolution // 2,
            anchor_sizes=spec.anchor_sizes, anchor_ratios=spec.anchor_ratios,
            backbone=spec.backbone,
            **{f: getattr(spec, f) for f in ModelSpec.__dataclass_fields__
               if f.startswith(("vit_", "mvit_"))})
        assert config_from_spec(spec) == want
        assert not config_from_spec(spec).bf16   # training's dtype, unset
    with pytest.raises(ValueError):
        model_spec({"model_backbone": "swin"})


# -- detectron2's names -------------------------------------------------------

def _fake_mvit_state_dict():
    """A detectron2 MViTv2 Mask R-CNN state dict at the tiny widths: the
    names and shapes of ``modeling/backbone/mvit.py`` and
    ``mask_rcnn_fpn.py``'s heads, random values."""
    rng = np.random.default_rng(0)
    sd = {}

    def put(name, *shape):
        sd[name] = torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32) * 0.05)

    bu = "backbone.bottom_up"
    put(f"{bu}.patch_embed.proj.weight", 16, 3, 7, 7)
    put(f"{bu}.patch_embed.proj.bias", 16)
    model = MaskRCNN(tiny_cfg())
    widths = []
    for i, block in enumerate(model.backbone.bottom_up.blocks):
        attn = block.attn
        cin = block.norm1.scale.shape[0]
        cout = attn.proj.weight.shape[0]
        d = attn.head_dim
        p = f"{bu}.blocks.{i}"
        for norm, c in (("norm1", cin), ("norm2", cout)):
            put(f"{p}.{norm}.weight", c)
            put(f"{p}.{norm}.bias", c)
        put(f"{p}.attn.qkv.weight", 3 * cout, cin)
        put(f"{p}.attn.qkv.bias", 3 * cout)
        for name in "qkv":
            put(f"{p}.attn.pool_{name}.weight", d, 1, 3, 3)
            put(f"{p}.attn.norm_{name}.weight", d)
            put(f"{p}.attn.norm_{name}.bias", d)
        put(f"{p}.attn.rel_pos_h", attn.rel_pos_h.shape[0], d)
        put(f"{p}.attn.rel_pos_w", attn.rel_pos_w.shape[0], d)
        put(f"{p}.attn.proj.weight", cout, cout)
        put(f"{p}.attn.proj.bias", cout)
        if cin != cout:
            put(f"{p}.proj.weight", cout, cin)
            put(f"{p}.proj.bias", cout)
        put(f"{p}.mlp.fc1.weight", 4 * cout, cout)
        put(f"{p}.mlp.fc1.bias", 4 * cout)
        put(f"{p}.mlp.fc2.weight", cout, 4 * cout)
        put(f"{p}.mlp.fc2.bias", cout)
        if i in (0, 2, 3, 4):
            put(f"{bu}.scale{len(widths) + 2}_norm.weight", cout)
            put(f"{bu}.scale{len(widths) + 2}_norm.bias", cout)
            widths.append(cout)
    for lvl, c in zip(range(2, 6), widths):
        put(f"backbone.fpn_lateral{lvl}.weight", 256, c, 1, 1)
        put(f"backbone.fpn_lateral{lvl}.bias", 256)
        put(f"backbone.fpn_output{lvl}.weight", 256, 256, 3, 3)
        put(f"backbone.fpn_output{lvl}.bias", 256)
    rpn = "proposal_generator.rpn_head"
    put(f"{rpn}.conv.weight", 256, 256, 3, 3)
    put(f"{rpn}.conv.bias", 256)
    put(f"{rpn}.objectness_logits.weight", 3, 256, 1, 1)
    put(f"{rpn}.objectness_logits.bias", 3)
    put(f"{rpn}.anchor_deltas.weight", 12, 256, 1, 1)
    put(f"{rpn}.anchor_deltas.bias", 12)
    put("roi_heads.box_head.fc1.weight", 1024, 256 * 49)
    put("roi_heads.box_head.fc1.bias", 1024)
    put("roi_heads.box_head.fc2.weight", 1024, 1024)
    put("roi_heads.box_head.fc2.bias", 1024)
    put("roi_heads.box_predictor.cls_score.weight", 2, 1024)
    put("roi_heads.box_predictor.cls_score.bias", 2)
    put("roi_heads.box_predictor.bbox_pred.weight", 4, 1024)
    put("roi_heads.box_predictor.bbox_pred.bias", 4)
    for i in range(1, 5):
        put(f"roi_heads.mask_head.mask_fcn{i}.weight", 256, 256, 3, 3)
        put(f"roi_heads.mask_head.mask_fcn{i}.bias", 256)
    put("roi_heads.mask_head.deconv.weight", 256, 256, 2, 2)
    put("roi_heads.mask_head.deconv.bias", 256)
    put("roi_heads.mask_head.predictor.weight", 1, 256, 1, 1)
    put("roi_heads.mask_head.predictor.bias", 1)
    return sd


def test_detectron2_mvit_names_convert_and_load(tmp_path):
    sd = _fake_mvit_state_dict()
    out = convert_detectron2_state_dict(sd)
    model = MaskRCNN(tiny_cfg())
    model.load_state_dict(out, strict=True)
    bu = model.backbone.bottom_up
    torch.testing.assert_close(bu.blocks[1].attn.norm_k.scale,
                               sd["backbone.bottom_up.blocks.1.attn.norm_k."
                                  "weight"])
    torch.testing.assert_close(bu.blocks[1].attn.pool_q.weight,
                               sd["backbone.bottom_up.blocks.1.attn.pool_q."
                                  "weight"])
    torch.testing.assert_close(bu.blocks[3].proj.bias,
                               sd["backbone.bottom_up.blocks.3.proj.bias"])
    torch.testing.assert_close(bu.scale4_norm.scale,
                               sd["backbone.bottom_up.scale4_norm.weight"])
    torch.testing.assert_close(model.backbone.fpn.output3.weight,
                               sd["backbone.fpn_output3.weight"])
    torch.testing.assert_close(model.rpn_head.conv.weight,
                               sd["proposal_generator.rpn_head.conv.weight"])
    w = sd["roi_heads.box_head.fc1.weight"].reshape(1024, 256, 7, 7)
    torch.testing.assert_close(model.box_head.fc1.weight,
                               w.permute(0, 2, 3, 1).reshape(1024, -1))
    # the global block's resized tables follow the loaded ones
    torch.testing.assert_close(bu.blocks[2].attn.rel_w_used, resize_table(
        sd["backbone.bottom_up.blocks.2.attn.rel_pos_w"], 31))
    # and the .pth route: load_checkpoint recognises MViTv2 by its keys
    torch.save({"model": sd}, tmp_path / "model_final.pth")
    again = load_checkpoint(str(tmp_path / "model_final.pth"))
    assert set(again) == set(out)
    with torch.no_grad():
        outs = model(torch.zeros(1, 128, 128, 3))
    assert outs.boxes.shape == (1, 20, 4)
