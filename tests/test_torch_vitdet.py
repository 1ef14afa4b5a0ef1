"""Mask R-CNN ViTDet in the port (``models/vit.py``, the attention kernel's
plain version in ``ops/kernels/relpos_attention.py``, ViTDet's heads)
against the benchmark's float32 reference (``benchmark/reference/vitdet.py``)
on seeded weights from ``benchmark/weights_vitdet.py``, at a tiny size on
the CPU: 128 input, patch 16, width 64, 4 blocks (1 and 3 global), 4 heads,
window 3, so that the 8 x 8 map pads to 9 x 9 and the global tables have 15
rows.  Also the loaders (the Flax layout strictly, detectron2's ViTDet key
names), the RGB input order, and the R-FPN path left as it was."""

import json
import re
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
import weights_vitdet  # noqa: E402
from frozen.synthetic import make_sheet  # noqa: E402
from reference.maskrcnn import tensors  # noqa: E402
from reference.vitdet import NET, ViTDet  # noqa: E402

from treedetection_tpu_torch.config import (  # noqa: E402
    Config, model_spec, prepare_config)
from treedetection_tpu_torch.models.convert import (  # noqa: E402
    convert_detectron2_state_dict, load_checkpoint)
from treedetection_tpu_torch.models.mask_rcnn import (  # noqa: E402
    MaskRCNN, MaskRCNNConfig)
from treedetection_tpu_torch.models.rpn import RPNHead  # noqa: E402
from treedetection_tpu_torch.ops.image import (  # noqa: E402
    normalize_bgr, normalize_image, rgbi_to_model_input)
from treedetection_tpu_torch.ops.kernels.relpos_attention import (  # noqa
    relpos_attention, relpos_attention_reference)
from treedetection_tpu_torch.prediction import Predictor  # noqa: E402

CONFIG = json.loads((BENCH / "configs" / "mask_rcnn_vitdet_l.json")
                    .read_text())
TINY = dict(CONFIG["model"], input_size=128, vit_dim=64, vit_depth=4,
            vit_heads=4, vit_window=3, vit_global_blocks=[1, 3],
            rpn_pre_nms_topk=200, rpn_post_nms_topk=64, max_detections=20)
TINY_PROGRAM = dict(CONFIG["program"], model_input_size=128,
                    vit_embed_dim=64, vit_depth=4, vit_num_heads=4,
                    vit_window_size=3, vit_global_blocks=[1, 3],
                    rpn_pre_nms_topk=200, rpn_post_nms_topk=64,
                    max_detections=20, batch_size=2, mixed_precision=False)
PAD = 100          # tiles resized 100 -> 128, as the cell resizes 456 -> 1024


def tiny_cfg(**over) -> MaskRCNNConfig:
    return MaskRCNNConfig(
        backbone="vit", input_size=128, vit_dim=64, vit_depth=4,
        vit_heads=4, vit_window=3, vit_global_blocks=(1, 3),
        rpn_pre_nms_topk=200,
        rpn_post_nms_topk=64, max_detections=20, **over)


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
    w = weights_vitdet.make_weights(TINY, CONFIG["weights"], 2 ** 32 + 11,
                                    torch.device("cpu"))
    weights_vitdet.calibrate(w, TINY, CONFIG["weights"], tiles,
                             torch.device("cpu"))
    path = tmp_path_factory.mktemp("vitdet") / "weights.npz"
    bench_weights.write_weights(str(path), w)
    return path, w, tiles


def _port(path) -> MaskRCNN:
    model = MaskRCNN(tiny_cfg())
    model.load_state_dict(load_checkpoint(str(path)), strict=True)
    return model.eval()


def _reference(w) -> ViTDet:
    return ViTDet(tensors(w, torch.device("cpu")), TINY)


# -- the attention ------------------------------------------------------------

# (batch, map H, map W, window (0: global), one table per head): the
# kernel's edges at a tiny size.  The windowed 8 x 8 map pads to 9 x 9 (its
# pad keys are the qkv bias, unmasked) and the global block has 15-row
# tables; 7 x 10 is a multiple of window 4 in neither direction; the global
# 6 x 7 map's width fits no row-aligned key tile.
ATTENTION_CASES = {
    "windowed": (2, 8, 8, 3, False),
    "global": (2, 8, 8, 0, False),
    "windowed_ragged_map": (2, 7, 10, 4, False),
    "global_unaligned_width": (2, 6, 7, 0, False),
    "windowed_tables_per_head": (2, 8, 8, 3, True),
    "global_tables_per_head": (1, 6, 7, 0, True),
    "batch_1": (1, 8, 8, 3, False),
}


@pytest.mark.parametrize("case", ATTENTION_CASES)
def test_attention_plain_version_matches_the_materialised_reference(case):
    """The plain version against detectron2's attention written out (the
    reference's ``block_attention`` with an identity projection) on the
    shapes of ``ATTENTION_CASES``.  With a table per head, the reference
    runs once a head with that head's tables."""
    b, h, w, window, per_head = ATTENTION_CASES[case]
    gen = torch.Generator().manual_seed(1)
    heads, d = 4, 16
    c = heads * d
    x = torch.randn(b, h, w, c, generator=gen)
    kernel = torch.randn(c, 3 * c, generator=gen) * (2.0 / c ** 0.5)
    bias = torch.randn(3 * c, generator=gen)
    sh, sw = (window, window) if window else (h, w)
    lead = (heads,) if per_head else ()
    rh = torch.randn(*lead, 2 * sh - 1, d, generator=gen) * 0.3
    rw = torch.randn(*lead, 2 * sw - 1, d, generator=gen) * 0.3
    got = relpos_attention(x @ kernel + bias, bias, rh, rw, heads, window)
    blk = f"{NET}/blocks_0/attn"
    model = dict(TINY, vit_heads=heads, vit_window=window or 3,
                 vit_global_blocks=[] if window else [0], vit_depth=1)
    want = torch.empty(b, h, w, c)
    for head in range(heads if per_head else 1):
        weights = {f"{blk}/qkv/kernel": kernel, f"{blk}/qkv/bias": bias,
                   f"{blk}/proj/kernel": torch.eye(c),
                   f"{blk}/proj/bias": torch.zeros(c),
                   f"{blk}/rel_pos_h": rh[head] if per_head else rh,
                   f"{blk}/rel_pos_w": rw[head] if per_head else rw}
        out = ViTDet(weights, model).block_attention(x, 0)
        cols = slice(head * d, (head + 1) * d) if per_head else slice(None)
        want[..., cols] = out[..., cols]
    assert got.shape == (b, h, w, c)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_every_attention_kernel_carries_the_name_the_benchmark_reads():
    """The benchmark's ``relpos_attn_ms`` and ``relpos_attn_roofline`` and
    ``chip_smoke.py`` find the kernel's device time by a substring of its
    name: every ``__global__`` function of the source carries it."""
    from metrics.relpos_attn_roofline import KERNEL
    src = (REPO / "treedetection_tpu_torch" / "csrc" /
           "relpos_attention.cu").read_text()
    code = re.sub(r"//[^\n]*", "", src)
    names = re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
        code)
    assert len(names) == code.count("__global__") >= 1
    assert all(KERNEL in name for name in names), names


def test_attention_tables_per_head_and_the_bias_matter():
    """One table per head, all the same, gives the shared table's output;
    the bias terms and the pad keys each move it."""
    gen = torch.Generator().manual_seed(2)
    b, h, w, heads, d = 1, 8, 8, 2, 16
    qkv = torch.randn(b, h, w, 3 * heads * d, generator=gen) * 1.5
    bias = torch.randn(3 * heads * d, generator=gen)
    rh = torch.randn(5, d, generator=gen) * 0.5
    rw = torch.randn(5, d, generator=gen) * 0.5
    shared = relpos_attention_reference(qkv, bias, rh, rw, heads, 3)
    per_head = relpos_attention_reference(
        qkv, bias, rh.expand(heads, 5, d), rw.expand(heads, 5, d), heads, 3)
    torch.testing.assert_close(per_head, shared, rtol=0, atol=0)
    no_bias = relpos_attention_reference(qkv, bias, rh * 0, rw * 0, heads, 3)
    assert (no_bias - shared).abs().max() > 1e-2
    other_pads = relpos_attention_reference(qkv, bias * 0, rh, rw, heads, 3)
    # the last window row and column hold pads; the first window none
    assert (other_pads - shared)[:, 6:, 6:].abs().max() > 1e-2
    torch.testing.assert_close(other_pads[:, :6, :6], shared[:, :6, :6])


def test_attention_refuses_what_it_does_not_take():
    qkv = torch.zeros(1, 4, 4, 3 * 32)
    with pytest.raises(ValueError):
        relpos_attention(qkv, torch.zeros(96), torch.zeros(7, 16),
                         torch.zeros(7, 16), 2, 3)     # tables of side 4
    with pytest.raises(ValueError):
        relpos_attention(qkv[..., :-1], torch.zeros(95), torch.zeros(5, 16),
                         torch.zeros(5, 16), 2, 3)


# -- the backbone and the model -----------------------------------------------

def test_seeded_weights_load_strictly(seeded):
    path, w, _ = seeded
    sd = load_checkpoint(str(path))
    model = MaskRCNN(tiny_cfg())
    missing = set(model.state_dict()) ^ set(sd)
    assert not missing, sorted(missing)[:10]
    model.load_state_dict(sd, strict=True)
    # every leaf of the weights module is a parameter of the model
    assert len(weights_vitdet.leaves(TINY)) == len(sd) == len(w)
    # the position embedding at the map is set at load, from the 14 x 14
    # grid of the checkpoint, not left at zero
    assert model.backbone.net.pos_embed_map.abs().max() > 0


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
    """The whole model through the Predictor (RGB input, resize, the ViT,
    the heads) to detections, against the reference's, at
    ``tests/test_oracle.py``'s tolerances."""
    path, w, tiles = seeded
    pred = _predictor(tmp_path, path)
    assert not pred.used_random_init
    assert pred.cfg.backbone == "vit" and pred.spec.input_format == "RGB"
    forward, _ = pred._get_forward(PAD)
    out = forward(np.ascontiguousarray(tiles[:2]))[0][0]
    ref = _reference(w)
    size = 128
    with torch.no_grad():
        feats, rpn = ref.features(torch.from_numpy(tiles[:2]))
        for j in range(2):
            det = ref.detect(feats, rpn, j, cut=True)
            nv = int(out.valid[j].sum())
            assert nv == len(det.scores) and nv > 0
            boxes = out.boxes[j][:nv].numpy()
            assert np.abs(boxes - det.boxes.numpy()).max() < 1e-3 * size / 128
            assert np.abs(out.scores[j][:nv].numpy()
                          - det.scores.numpy()).max() < 1e-4
            masks = out.masks[j][:nv].numpy().astype(np.float32) / 255.0
            assert np.abs(masks - det.masks.numpy()).max() < 0.02


# -- the input order ----------------------------------------------------------

def test_input_order_bgr_flips_and_rgb_keeps():
    rgb = torch.from_numpy(np.random.default_rng(4).integers(
        0, 255, (2, 5, 5, 4), dtype=np.uint8))
    mean, std = (10.0, 20.0, 30.0), (2.0, 3.0, 4.0)
    bgr = normalize_image(rgb, mean, std, "BGR")
    torch.testing.assert_close(bgr, normalize_bgr(rgb, mean, std), rtol=0,
                               atol=0)
    torch.testing.assert_close(
        bgr, (rgb[..., [2, 1, 0]].float() - torch.tensor(mean))
        / torch.tensor(std), rtol=0, atol=0)
    got = normalize_image(rgb, mean, std, "RGB")
    torch.testing.assert_close(
        got, (rgb[..., :3].float() - torch.tensor(mean)) / torch.tensor(std),
        rtol=0, atol=0)
    with pytest.raises(ValueError):
        normalize_image(rgb, mean, std, "HSV")
    torch.testing.assert_close(
        rgbi_to_model_input(rgb, 8, mean, std, input_format="BGR"),
        rgbi_to_model_input(rgb, 8, mean, std), rtol=0, atol=0)
    # with the same mean and std on every channel the two orders differ
    # only by the flip
    both = [rgbi_to_model_input(rgb, 8, (20.0,) * 3, (3.0,) * 3,
                                input_format=f) for f in ("BGR", "RGB")]
    torch.testing.assert_close(both[0].flip(-1), both[1])


def test_input_format_key_reaches_the_predictor(seeded, tmp_path):
    path, _, tiles = seeded
    assert model_spec({}).input_format == "BGR"
    assert model_spec({"input_format": "rgb"}).input_format == "RGB"
    with pytest.raises(ValueError):
        model_spec({"input_format": "YUV"})
    raw = torch.from_numpy(tiles[:1])
    for fmt in ("RGB", "BGR"):
        (tmp_path / fmt).mkdir()
        pred = _predictor(tmp_path / fmt, path, input_format=fmt)
        x = pred.preprocess(raw, PAD)
        want = normalize_image(raw, pred.spec.pixel_mean,
                               pred.spec.pixel_std, fmt)
        from treedetection_tpu_torch.ops.image import resize_bilinear
        torch.testing.assert_close(x, resize_bilinear(want, 128, 128))


def test_backbone_keys_select_the_model():
    spec = model_spec({"model_backbone": "vit", "vit_window_size": 7,
                       "vit_global_blocks": [2]})
    assert (spec.backbone, spec.vit_window, spec.vit_global_blocks) == (
        "vit", 7, (2,))
    assert model_spec({}).backbone == "resnet"
    with pytest.raises(ValueError):
        model_spec({"model_backbone": "swin"})
    # the backbone brings its heads: ViTDet's two RPN convs, 4conv1fc box
    # head and LayerNorm heads
    model = MaskRCNN(tiny_cfg())
    assert len(model.rpn_head.conv) == 2 and model.box_head.num_convs == 4
    assert not hasattr(model.box_head, "fc2")
    assert model.mask_head.mask_fcn1.bias is None
    assert model.mask_head.mask_fcn1.norm.scale.shape == (256,)


# -- the R-FPN path as it was -------------------------------------------------

def test_rpn_head_with_one_conv_is_the_rfpn_head():
    """One conv keeps R-FPN's keys and its outputs: relu(conv) and the two
    1x1 heads, as the head computed them before it took a count."""
    torch.manual_seed(5)
    head = RPNHead(num_anchors=3, features=16)
    assert sorted(head.state_dict()) == sorted(
        f"{n}.{p}" for n in ("conv", "objectness_logits", "anchor_deltas")
        for p in ("weight", "bias"))
    f = torch.randn(2, 6, 6, 16)
    logits, deltas = head([f])
    t = torch.relu(torch.nn.functional.conv2d(
        f.permute(0, 3, 1, 2), head.conv.weight, head.conv.bias, padding=1))
    want = torch.nn.functional.conv2d(
        t, head.objectness_logits.weight,
        head.objectness_logits.bias).permute(0, 2, 3, 1)
    torch.testing.assert_close(logits[0], want, rtol=0, atol=0)
    two = RPNHead(num_anchors=3, features=16, num_convs=2)
    assert {k for k in two.state_dict() if k.startswith("conv.")} == {
        "conv.conv0.weight", "conv.conv0.bias", "conv.conv1.weight",
        "conv.conv1.bias"}


def test_resnet_model_keys_are_unchanged():
    """The default configuration builds the R-FPN model with its keys: no
    ViT, no head convs or norms, the box head's two FCs."""
    model = MaskRCNN(MaskRCNNConfig(depth=50, input_size=128))
    keys = set(model.state_dict())
    assert not any(".net." in k or ".norm.scale" in k and "head" in k
                   for k in keys)
    assert {"box_head.fc1.weight", "box_head.fc2.weight",
            "rpn_head.conv.weight", "mask_head.mask_fcn1.bias"} <= keys
    assert not any(k.startswith("box_head.conv") for k in keys)


# -- detectron2's ViTDet names ------------------------------------------------

def _fake_vitdet_state_dict(seed: int = 0):
    """A detectron2 ViTDet state dict at the tiny widths, random values,
    with detectron2's names and shapes."""
    rng = np.random.default_rng(seed)
    d, heads, hd, f = 64, 4, 16, 256
    sd = {}

    def put(key, *shape):
        sd[key] = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * 0.05)

    net = "backbone.net"
    put(f"{net}.patch_embed.proj.weight", d, 3, 16, 16)
    put(f"{net}.patch_embed.proj.bias", d)
    put(f"{net}.pos_embed", 1, 197, d)
    for i in range(4):
        side = 8 if i in (1, 3) else 3
        blk = f"{net}.blocks.{i}"
        for n in ("norm1", "norm2"):
            put(f"{blk}.{n}.weight", d)
            put(f"{blk}.{n}.bias", d)
        put(f"{blk}.attn.qkv.weight", 3 * d, d)
        put(f"{blk}.attn.qkv.bias", 3 * d)
        put(f"{blk}.attn.proj.weight", d, d)
        put(f"{blk}.attn.proj.bias", d)
        put(f"{blk}.attn.rel_pos_h", 2 * side - 1, hd)
        put(f"{blk}.attn.rel_pos_w", 2 * side - 1, hd)
        put(f"{blk}.mlp.fc1.weight", 4 * d, d)
        put(f"{blk}.mlp.fc1.bias", 4 * d)
        put(f"{blk}.mlp.fc2.weight", d, 4 * d)
        put(f"{blk}.mlp.fc2.bias", d)
    del heads

    def conv_ln(key, cout, cin, k):
        put(f"{key}.weight", cout, cin, k, k)
        put(f"{key}.norm.weight", cout)
        put(f"{key}.norm.bias", cout)

    put("backbone.simfp_2.0.weight", d, d // 2, 2, 2)
    put("backbone.simfp_2.0.bias", d // 2)
    put("backbone.simfp_2.1.weight", d // 2)
    put("backbone.simfp_2.1.bias", d // 2)
    put("backbone.simfp_2.3.weight", d // 2, d // 4, 2, 2)
    put("backbone.simfp_2.3.bias", d // 4)
    put("backbone.simfp_3.0.weight", d, d // 2, 2, 2)
    put("backbone.simfp_3.0.bias", d // 2)
    for level, first, cin in ((2, 4, d // 4), (3, 1, d // 2), (4, 0, d),
                              (5, 1, d)):
        conv_ln(f"backbone.simfp_{level}.{first}", f, cin, 1)
        conv_ln(f"backbone.simfp_{level}.{first + 1}", f, f, 3)
    rpn = "proposal_generator.rpn_head"
    for i in range(2):
        put(f"{rpn}.conv.conv{i}.weight", f, f, 3, 3)
        put(f"{rpn}.conv.conv{i}.bias", f)
    put(f"{rpn}.objectness_logits.weight", 3, f, 1, 1)
    put(f"{rpn}.objectness_logits.bias", 3)
    put(f"{rpn}.anchor_deltas.weight", 12, f, 1, 1)
    put(f"{rpn}.anchor_deltas.bias", 12)
    for i in range(1, 5):
        conv_ln(f"roi_heads.box_head.conv{i}", f, f, 3)
        conv_ln(f"roi_heads.mask_head.mask_fcn{i}", f, f, 3)
    put("roi_heads.box_head.fc1.weight", 1024, f * 49)
    put("roi_heads.box_head.fc1.bias", 1024)
    put("roi_heads.box_predictor.cls_score.weight", 2, 1024)
    put("roi_heads.box_predictor.cls_score.bias", 2)
    put("roi_heads.box_predictor.bbox_pred.weight", 4, 1024)
    put("roi_heads.box_predictor.bbox_pred.bias", 4)
    put("roi_heads.mask_head.deconv.weight", f, f, 2, 2)
    put("roi_heads.mask_head.deconv.bias", f)
    put("roi_heads.mask_head.predictor.weight", 1, f, 1, 1)
    put("roi_heads.mask_head.predictor.bias", 1)
    return sd


def test_detectron2_vitdet_names_convert_and_load(tmp_path):
    sd = _fake_vitdet_state_dict()
    out = convert_detectron2_state_dict(sd)
    model = MaskRCNN(tiny_cfg())
    model.load_state_dict(out, strict=True)
    torch.testing.assert_close(
        model.backbone.net.blocks[2].norm1.scale,
        sd["backbone.net.blocks.2.norm1.weight"])
    torch.testing.assert_close(model.backbone.pyramid.up2.deconv2.weight,
                               sd["backbone.simfp_2.3.weight"])
    torch.testing.assert_close(model.backbone.pyramid.lateral3.norm.bias,
                               sd["backbone.simfp_3.1.norm.bias"])
    torch.testing.assert_close(model.rpn_head.conv.conv1.weight,
                               sd[
                                   "proposal_generator.rpn_head.conv.conv1."
                                   "weight"])
    torch.testing.assert_close(
        model.mask_head.mask_fcn4.norm.scale,
        sd["roi_heads.mask_head.mask_fcn4.norm.weight"])
    # fc1 reads the (R, R, C) pooled layout: detectron2's CHW columns
    w = sd["roi_heads.box_head.fc1.weight"].reshape(1024, 256, 7, 7)
    torch.testing.assert_close(model.box_head.fc1.weight,
                               w.permute(0, 2, 3, 1).reshape(1024, -1))
    # the position embedding at the map follows the loaded grid
    assert model.backbone.net.pos_embed_map.abs().max() > 0
    # and the .pth route: load_checkpoint recognises ViTDet by its keys
    torch.save({"model": sd}, tmp_path / "model_final.pth")
    again = load_checkpoint(str(tmp_path / "model_final.pth"))
    assert set(again) == set(out)
    with torch.no_grad():
        outs = model(torch.zeros(1, 128, 128, 3))
    assert outs.boxes.shape == (1, 20, 4)


def test_the_port_never_calls_a_library_attention():
    """Attention in the port is the hand-written kernel (or, on the CPU, its
    plain version): no source of the package calls PyTorch's fused
    attention."""
    port = REPO / "treedetection_tpu_torch"
    for path in port.rglob("*.py"):
        assert "scaled_dot_product_attention" not in path.read_text(), path
