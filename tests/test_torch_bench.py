"""The port's bench (``treedetection_tpu_torch/bench.py``) against the JAX
package's root ``bench.py``, on the CPU at small sizes.

(a) the JSON line's keys are ``bench.py``'s, read statically with ``ast``
(no JAX import), less the documented omissions, plus ``gpu``, and are the
bench's own key sets; (b) the bench's forward (uint8 tiles -> normalize ->
model -> host ``ModelOutput``) against JAX's ``model.apply(p,
normalize_bgr(tiles))`` on the same weights; (c) its polygonization
against the same loop through the JAX package's native library; (d) a
whole ``--device cpu`` run; (e) no CUDA and no ``--device cpu``, or the
card without a source checkout: a non-zero exit and no line; another card
than the first is refused; (f) one ``process_files`` pass on a small
synthetic sheet, its counts against the files it wrote.
"""

import ast
import contextlib
import dataclasses
import glob
import io
import json
import math
import os
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_jax_native import jax_native  # noqa: E402,F401 (fixture)
from treedetection_tpu_torch import bench, prediction  # noqa: E402
from treedetection_tpu_torch.models.convert import from_flax_params  # noqa: E402
from treedetection_tpu_torch.models.mask_rcnn import MaskRCNN  # noqa: E402
from treedetection_tpu_torch.vector import read_gpkg  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
OMITTED = {"tunnel_e2e_tiles_per_sec", "pipeline_error"}
SIZE = 128            # the CPU configuration at a smaller input
SMALL_SHEET_PX = 500  # 100 m at 0.2 m: 4 tiles of 50 m
SMALL_PIPELINE = {"model_input_size": 128, "batch_size": 4}
# 16 tiles of 25 m without buffer, one tile of overlap band: the example's
# band of 3 tiles of 90 m would cover the whole 100 m sheet
CROWN_PIPELINE = {"model_input_size": 256, "batch_size": 4,
                  "tile_width": 25, "tile_height": 25, "buffer": 0,
                  "overlapping_tiles_width": 1, "overlapping_tiles_height": 1}


def _jax_bench_keys():
    """-> (keys of ``main``'s ``result`` literal, every key the JAX bench's
    line can carry): the literal, ``result[...]`` and ``warm[...]``
    assignments, and the dict that ``_pipeline_pass`` returns."""
    tree = ast.parse((REPO / "bench.py").read_text())
    funcs = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}
    literal, every = set(), set()
    for node in ast.walk(funcs["main"]):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and [getattr(t, "id", None) for t in node.targets] == ["result"]:
            literal |= {k.value for k in node.value.keys}
    for func, name in (("main", "result"), ("bench_pipeline", "warm")):
        for node in ast.walk(funcs[func]):
            if isinstance(node, ast.Subscript) and \
                    isinstance(node.ctx, ast.Store) and \
                    getattr(node.value, "id", None) == name:
                every.add(node.slice.value)
    for node in ast.walk(funcs["_pipeline_pass"]):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            every |= {k.value for k in node.value.keys}
    return literal, every | literal


def _run_main(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench.main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def cpu_run():
    """One whole ``--device cpu`` run -> (exit code, stdout, stderr,
    whether the history file changed)."""
    before = bench.HISTORY.read_bytes() if bench.HISTORY.exists() else None
    run = _run_main(["--device", "cpu"])
    after = bench.HISTORY.read_bytes() if bench.HISTORY.exists() else None
    return run + (before != after,)


def test_cpu_run_prints_one_parseable_line(cpu_run):
    rc, out, err, history_changed = cpu_run
    assert rc == 0
    lines = out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[-1])
    assert line["model"] == "mask_rcnn_r50_fpn_256"
    assert line["vs_baseline"] is None and line["gpu"] is None
    assert math.isfinite(line["value"]) and line["value"] > 0
    assert line["pipelined_tiles_per_sec_min"] <= line["value"] \
        <= line["pipelined_tiles_per_sec_max"]
    assert line["metric"] == ("256^2 RGB tiles/sec/chip (model+mask->polygon "
                              "pipelined, median of 1 passes)")
    assert not history_changed
    assert "rings" in err


def test_without_cuda_the_bench_exits_non_zero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run_main([])
    assert rc != 0 and out == ""
    assert "CUDA is not available" in err


def test_the_bench_measures_the_first_card_only(capsys):
    with pytest.raises(SystemExit) as info:
        bench.main(["--device", "cuda:1"])
    assert info.value.code == 2
    assert "the first card" in capsys.readouterr().err


def test_on_the_card_without_a_checkout_the_bench_exits_non_zero(
        monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "EXAMPLE", tmp_path / "config.yml")
    rc, out, err = _run_main([])
    assert rc != 0 and out == ""
    assert "config.yml not found" in err and "source checkout" in err


def _count_tiles(tiles_dir):
    n = 0
    for f in glob.glob(os.path.join(tiles_dir, "*.json")):
        with open(f) as fh:
            n += len(json.load(fh))
    return n


def test_one_pipeline_pass_counts_what_it_wrote(tmp_path):
    bench.write_sheet(tmp_path / "sheet", SMALL_SHEET_PX)
    got = bench.pipeline_pass(tmp_path / "sheet", tmp_path / "run", "cpu",
                              **CROWN_PIPELINE)
    tiles = _count_tiles(tmp_path / "run" / "tiles")
    gpkgs = glob.glob(str(tmp_path / "run" / "out" / "**" / "*.gpkg"),
                      recursive=True)
    processed = [p for p in gpkgs
                 if os.path.basename(p).startswith("processed_")]
    assert len(processed) == 1, gpkgs
    assert got["pipeline_tiles"] == tiles == 16
    assert got["pipeline_crowns"] == len(read_gpkg(processed[0])[0]) > 0
    assert got["pipeline_wall_s"] > 0
    assert got["pipeline_compile_s"] == round(
        prediction.LAST_RUN_STATS["compile_s"], 1)
    assert got["pipeline_tiles_per_sec_excl_compile"] >= \
        got["pipeline_tiles_per_sec"] > 0
    assert isinstance(got["postprocess_phase_s"], dict)


def test_line_keys_are_the_jax_benchs(cpu_run, tmp_path):
    """The CPU line carries ``main``'s literal keys; with the history band
    and a two-pass pipeline part the card's line carries every key."""
    literal, every = _jax_bench_keys()
    assert {"metric", "value", "pipeline_tiles", "pipeline_first_wall_s",
            "pipelined_between_run_band"} <= every
    assert bench.MODEL_KEYS == literal - OMITTED | {"gpu"}
    assert bench.MODEL_KEYS | bench.BAND_KEYS | bench.PIPELINE_KEYS == \
        every - OMITTED | {"gpu"}
    line = json.loads(cpu_run[1].splitlines()[-1])
    assert set(line) == bench.MODEL_KEYS
    band = bench.history_band(line, tmp_path / "history.jsonl")
    assert set(band) == bench.BAND_KEYS
    pipeline = bench.bench_pipeline("cpu", passes=2, side_px=SMALL_SHEET_PX,
                                    **SMALL_PIPELINE)
    assert set(pipeline) == bench.PIPELINE_KEYS


# --- (b) and (c): the forward and polygonization against the JAX package ---

@pytest.fixture(scope="module")
def forwards():
    """The bench's CPU configuration at 128^2 on the synthetic detectron2
    R50 weights (converted by the JAX package, carried to the port by
    ``from_flax_params``): (the port bench's host output, JAX's)."""
    from test_convert import _make_fake_d2_state_dict
    from treedetection_tpu.models import MaskRCNN as JaxMaskRCNN
    from treedetection_tpu.models import MaskRCNNConfig as JaxConfig
    from treedetection_tpu.models.convert import convert_detectron2_state_dict
    from treedetection_tpu.ops.image import normalize_bgr as jax_normalize
    from treedetection_tpu.ops.pack import (
        pack_model_output, unpack_model_output)
    cfg, *_ = bench.bench_setup(on_cpu=True)
    cfg = dataclasses.replace(cfg, input_size=SIZE)
    params = convert_detectron2_state_dict(
        _make_fake_d2_state_dict(depth=cfg.depth), depth=cfg.depth)
    port = MaskRCNN(cfg).eval().requires_grad_(False)
    port.load_state_dict(from_flax_params(params), strict=True)
    jax_model = JaxMaskRCNN(JaxConfig(
        depth=cfg.depth, input_size=SIZE, bf16=False,
        rpn_pre_nms_topk=cfg.rpn_pre_nms_topk,
        rpn_post_nms_topk=cfg.rpn_post_nms_topk,
        max_detections=cfg.max_detections, rpn_approx_topk_from=0))
    tiles = np.random.default_rng(11).integers(0, 255, (2, SIZE, SIZE, 3),
                                               dtype=np.uint8)
    packed = jax.jit(lambda p, t: pack_model_output(
        jax_model.apply(p, jax_normalize(t))))(params, jnp.asarray(tiles))
    want = unpack_model_output(np.asarray(packed), cfg.max_detections)
    got = bench.fetch(bench.make_forward(port)(torch.from_numpy(tiles)))
    return got, want


def test_bench_forward_matches_jax(forwards):
    got, want = forwards
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid, valid)
    assert valid.sum() > 0, "no detections: the comparison is vacuous"
    for b in range(valid.shape[0]):
        nv = int(valid[b].sum())
        assert np.abs(got.boxes[b, :nv] - want.boxes[b, :nv]).max(
            initial=0) < 1e-3 * SIZE / 128
        assert np.abs(got.scores[b, :nv] - want.scores[b, :nv]).max(
            initial=0) < 1e-4
        gm = got.masks[b, :nv].astype(np.float32) / 255.0
        wm = np.asarray(want.masks[b, :nv]).astype(np.float32) / 255.0
        assert np.abs(gm - wm).max(initial=0) < 0.02


def test_polygonize_counts_the_jax_packages_rings(forwards, jax_native):
    from treedetection_tpu import native as jax_lib
    got, _ = forwards
    want = 0
    for b in range(got.valid.shape[0]):
        for d in range(got.valid.shape[1]):
            if not got.valid[b, d]:
                continue
            box = np.asarray(got.boxes[b, d])
            bw = max(int(box[2] - box[0]), 1)
            bh = max(int(box[3] - box[1]), 1)
            binary = jax_lib.resize_threshold_mask(
                np.asarray(got.masks[b, d]), min(bh, 512), min(bw, 512))
            want += len(jax_lib.trace_contours(binary))
    assert want > 0
    assert bench.polygonize(got) == want
