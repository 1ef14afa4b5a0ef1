"""The port's host pipeline and Predictor against the JAX package's, on the
CPU in float32, plus the port's isolation from JAX.

The Predictors share weights through one ``.npz`` written by the JAX
package's ``save_checkpoint_npz`` (the synthetic detectron2 R50 of
``test_convert``).
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_jax_native import jax_native  # noqa: F401 (fixture)
from treedetection_tpu_torch.config import select_device
from treedetection_tpu_torch.geo import GeoTiff
from treedetection_tpu_torch.preprocessing import tile_single_file

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "treedetection_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "cv2", "optax", "orbax",
             "treedetection_tpu")

PRED_CFG = {"model_depth": 50, "model_input_size": 128,
            "mixed_precision": False, "rpn_approx_topk_from": 0,
            "rpn_pre_nms_topk": 200, "rpn_post_nms_topk": 100,
            "max_detections": 20, "batch_size": 3, "eager_stitch": False,
            "num_workers": 2}


def test_tile_metadata_byte_identical(tmp_raster, tmp_path):
    from treedetection_tpu.preprocessing import (
        tile_single_file as jax_tile_single_file)
    for kw in ({}, {"buffer": 20, "tile_width": 50, "tile_height": 40}):
        ours = tile_single_file(tmp_raster["rgb"], str(tmp_path / "t"), **kw)
        theirs = jax_tile_single_file(tmp_raster["rgb"],
                                      str(tmp_path / "j"), **kw)
        assert Path(ours).read_bytes() == Path(theirs).read_bytes()
    # with a forest outline the flags are computed, as the JAX package's
    forest = [np.array([[411990., 5317890.], [412050., 5317890.],
                        [412050., 5318010.], [411990., 5318010.]])]
    ours = tile_single_file(tmp_raster["rgb"], str(tmp_path / "tf"),
                            buffer=5, tile_width=25, tile_height=25,
                            forest_polys=forest)
    theirs = jax_tile_single_file(tmp_raster["rgb"], str(tmp_path / "jf"),
                                  buffer=5, tile_width=25, tile_height=25,
                                  forest_polys=forest)
    assert Path(ours).read_bytes() == Path(theirs).read_bytes()
    flags = [(m["only_forest"], m["only_urban"])
             for m in json.loads(Path(ours).read_text()).values()]
    assert (True, False) in flags and (False, True) in flags


def test_geotiff_windows_match_jax(tmp_raster):
    from treedetection_tpu.geo import GeoTiff as JaxGeoTiff
    ours, theirs = GeoTiff(tmp_raster["ndsm"]), JaxGeoTiff(tmp_raster["ndsm"])
    assert (ours.width, ours.height, ours.crs, ours.nodata) == \
        (theirs.width, theirs.height, theirs.crs, theirs.nodata)
    assert tuple(ours.transform) == tuple(theirs.transform)
    for win in ((0, 0, 500, 500), (37, 120, 211, 95), (-30, 450, 100, 100),
                (480, -5, 60, 40)):
        np.testing.assert_array_equal(ours.read(win), theirs.read(win))
        np.testing.assert_array_equal(ours.read(win, fill_value=0),
                                      theirs.read(win, fill_value=0))
    rgb = GeoTiff(tmp_raster["rgb"])
    np.testing.assert_array_equal(rgb.read(), tmp_raster["rgbi"])
    for g in (ours, theirs, rgb):
        g.close()


def test_band_predrop_bounds_match_jax():
    from treedetection_tpu.prediction import band_predrop_bounds as jax_band
    from treedetection_tpu_torch.prediction import band_predrop_bounds
    full = {"tile_width": 50, "tile_height": 40, "buffer": 20,
            "overlapping_tiles_width": 3, "overlapping_tiles_height": 2,
            "image_merged_regex": r"FDOP20_(\d+)\.tif"}
    bounds = (412000.0, 5317000.0, 413000.0, 5318000.0)
    for cfg, name in ((full, "a.tif"), (full, "FDOP20_1.tif"),
                      ({k: v for k, v in full.items() if k != "buffer"},
                       "a.tif"), (dict(full, use_overlap=False), "a.tif")):
        assert band_predrop_bounds(cfg, name, bounds) == \
            jax_band(cfg, name, bounds)


@pytest.fixture(scope="module")
def shared_npz(tmp_path_factory):
    from test_convert import _make_fake_d2_state_dict
    from treedetection_tpu.models.convert import (
        convert_detectron2_state_dict, save_checkpoint_npz)
    path = str(tmp_path_factory.mktemp("w") / "model.npz")
    params = convert_detectron2_state_dict(_make_fake_d2_state_dict(depth=50),
                                           depth=50)
    save_checkpoint_npz(path, params)
    return path


def _load_predictions(out_dir):
    return {p.name: json.loads(p.read_text())
            for p in sorted(Path(out_dir).glob("Prediction_*.json"))}


def test_predictors_write_the_same_crowns(tmp_raster, tmp_path, shared_npz,
                                          jax_native):
    """Both Predictors on tmp_raster, same weights: the same tiles, the same
    crowns in the same order, scores within 1e-4 (float32 on both sides),
    and every polygon vertex within one raster pixel (0.2 m): a uint8 mask
    value that rounds differently can move a traced contour by one pixel of
    the resized mask, and nothing more.

    The tiles carry no buffer, so every window lies inside the raster.  A
    buffered edge tile is zero-filled beyond the raster, and anchors over
    that constant region get RPN scores equal up to float rounding; which
    of them survives top-k then depends on summation order, in either
    package.  ``jax_native``: the JAX side traces with its native library
    (``test_torch_jax_native.py``)."""
    import jax
    from treedetection_tpu.prediction import Predictor as JaxPredictor
    from treedetection_tpu_torch.prediction import Predictor
    meta = tile_single_file(tmp_raster["rgb"], str(tmp_path / "tiles"),
                            buffer=0, tile_width=50, tile_height=50)
    ours = Predictor(dict(PRED_CFG, device="cpu"), shared_npz)
    theirs = JaxPredictor(dict(PRED_CFG, devices=jax.devices("cpu")[:1]),
                          shared_npz)
    assert not ours.used_random_init and not theirs.used_random_init
    assert ours(tmp_raster["rgb"], meta, str(tmp_path / "ours")) == 4
    assert theirs(tmp_raster["rgb"], meta, str(tmp_path / "theirs")) == 4
    got = _load_predictions(tmp_path / "ours")
    want = _load_predictions(tmp_path / "theirs")
    assert sorted(got) == sorted(want) and len(got) == 4
    n_crowns = 0
    for name in want:
        assert len(got[name]) == len(want[name]), name
        for g, w in zip(got[name], want[name]):
            assert g["image_id"] == w["image_id"]
            assert abs(g["score"] - w["score"]) < 1e-4
            gp = np.asarray(g["polygon_coords"][0])
            wp = np.asarray(w["polygon_coords"][0])
            if gp.shape == wp.shape:
                assert np.abs(gp - wp).max() <= 0.2 + 1e-6, name
            else:   # a contour moved: compare the rings' extents
                assert np.abs(gp.min(0) - wp.min(0)).max() <= 0.2 + 1e-6
                assert np.abs(gp.max(0) - wp.max(0)).max() <= 0.2 + 1e-6
            n_crowns += 1
    assert n_crowns > 0, "no crowns: the comparison is vacuous"


@pytest.mark.parametrize("mode", ["fixed", "shortest_edge"])
def test_test_resize_modes_match_jax(mode):
    """Both test-time resize modes give the JAX Predictor's box scale, and
    the shortest-edge canvas is the resized tile plus zero padding."""
    import jax
    from treedetection_tpu.prediction import Predictor as JaxPredictor
    from treedetection_tpu_torch.prediction import Predictor
    cfg = dict(PRED_CFG, test_resize=mode, resize_shortest_edge=96,
               resize_max_size=200)
    ours = Predictor(dict(cfg, device="cpu"), None)
    theirs = JaxPredictor(dict(cfg, devices=jax.devices("cpu")[:1]), None)
    for pad in (96, 160, 456):
        assert ours._get_forward(pad)[1] == theirs._get_forward(pad)[1]
    raw = torch.full((1, 160, 160, 3), 200, dtype=torch.uint8)
    x = ours.preprocess(raw, 160)
    content = ours._content(160)
    assert x.shape == (1, 128, 128, 3)
    assert content == (96 if mode == "shortest_edge" else 128)
    assert bool((x[:, :content, :content] != 0).all())
    assert bool((x[:, content:] == 0).all()) and \
        bool((x[:, :, content:] == 0).all())


def test_predictor_runs_without_jax(tmp_raster, tmp_path):
    """A small port Predictor on the CPU in a fresh interpreter: jax, flax
    and treedetection_tpu are never imported (this test process has jax
    loaded by conftest, so only a subprocess can show it)."""
    script = f"""
import sys, json
from treedetection_tpu_torch.preprocessing import tile_single_file
from treedetection_tpu_torch.prediction import Predictor
meta = tile_single_file({tmp_raster['rgb']!r}, {str(tmp_path / 'tiles')!r},
                        buffer=20, tile_width=50, tile_height=50)
cfg = {{"device": "cpu", "model_depth": 50, "model_input_size": 64,
        "rpn_pre_nms_topk": 50, "rpn_post_nms_topk": 20,
        "max_detections": 5, "batch_size": 2, "num_workers": 1}}
n = Predictor(cfg, None)({tmp_raster['rgb']!r}, meta, {str(tmp_path / 'out')!r})
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "treedetection_tpu"))
print(json.dumps({{"written": n, "bad": bad}}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", script], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result == {"written": 4, "bad": []}


def test_process_files_runs_without_jax_and_yaml(tmp_raster, tmp_path):
    """``process_files`` of the port on the CPU from a dict config, in a
    fresh interpreter where jax, flax, yaml, cv2 and treedetection_tpu
    cannot be imported at all: tiling, prediction, the eager stitch,
    postprocessing with both rasters (both pair branches), the manifests;
    then ``cli`` and ``compat`` in the same interpreter."""
    (tmp_path / "model.ckpt").write_text("placeholder")   # random-init path
    script = f"""
import sys, json, os
BLOCKED = ("jax", "jaxlib", "flax", "yaml", "cv2", "treedetection_tpu")
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked in this test: " + name)
sys.meta_path.insert(0, Block())
from treedetection_tpu_torch.config import prepare_config
from treedetection_tpu_torch.detection import process_files
from treedetection_tpu_torch.vector import read_gpkg
root = {str(tmp_path)!r}
counts = []
for branch in ("0", "1"):
    os.environ["TD_PAIRS_DEVICE"] = branch
    cfg = {{"image_directory": "rgb", "height_data_path": "nDSM",
            "combined_model": "model.ckpt", "output_directory": "out" + branch,
            "tiles_path": "tiles" + branch, "tile_width": 50,
            "tile_height": 50, "buffer": 10, "batch_size": 2,
            "use_overlap": False, "device": "cpu", "model_depth": 50,
            "model_input_size": 64, "rpn_pre_nms_topk": 50,
            "rpn_post_nms_topk": 20, "max_detections": 5, "num_workers": 1,
            "ndvi_mean_threshold": -2.0, "ndvi_var_threshold": 99.0,
            "height_threshold": 0, "keep_intermediate": True,
            "mixed_precision": False}}
    config, _ = prepare_config(cfg, root)
    outputs = process_files(config)
    geoms, props, srs = read_gpkg(outputs[0])
    counts.append([len(outputs), srs, sorted(os.listdir(config["tiles_path"])),
                   os.path.exists(os.path.join(config["output_directory"],
                                               "recovery.yaml"))])
import numpy as np
from treedetection_tpu_torch import cli, compat
mask = np.zeros((8, 8), np.uint8)
mask[2:6, 2:6] = 1
ring = compat.polygon_from_mask(compat.rle_decode(compat.rle_encode(mask)))
extra = [cli.main(["bench"]), cli.main(["eval", outputs[0], outputs[0]]),
         len(ring) >= 8, "treedetection_tpu_torch.eval.scores" in sys.modules]
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(json.dumps({{"counts": counts, "bad": bad, "extra": extra}}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", script], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    # the unported bench exits with 2; eval scores the layer against itself
    # (so the scan above covers eval/); the RLE helpers need nothing else
    assert result["extra"] == [2, 0, True, True]
    assert result["counts"] == [
        [1, 25832, ["324125317.json", "recovery.yaml"], True]] * 2


def _imports(path: Path):
    """-> (imported root module, name of the enclosing function or None)."""
    tree = ast.parse(path.read_text(), filename=str(path))

    def walk(node, func):
        for child in ast.iter_child_nodes(node):
            inner = child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func
            if isinstance(child, ast.Import):
                for alias in child.names:
                    yield alias.name.split(".")[0], func
            elif isinstance(child, ast.ImportFrom) and child.module and \
                    child.level == 0:
                yield child.module.split(".")[0], func
            elif isinstance(child, ast.Call) and child.args and \
                    isinstance(child.args[0], ast.Constant) and \
                    isinstance(child.args[0].value, str) and \
                    getattr(child.func, "attr",
                            getattr(child.func, "id", "")) in (
                        "import_module", "__import__"):
                yield child.args[0].value.split(".")[0], func
            yield from walk(child, inner)

    yield from walk(tree, None)


def test_port_never_imports_jax_statically():
    """No jax, flax, optax, orbax, cv2 or treedetection_tpu anywhere in the
    port or in chip_smoke.py (the string ``treedetection_tpu.`` does not
    even occur), and yaml only inside ``config.load_config``."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    for f in files:
        found = list(_imports(f))
        bad = [m for m, _ in found if m in FORBIDDEN]
        assert not bad, f"{f.relative_to(REPO)} imports {bad}"
        for module, func in found:
            if module == "yaml":
                assert (f.name, func) == ("config.py", "load_config"), \
                    f"{f.relative_to(REPO)} imports yaml in {func}"
        assert "treedetection_tpu." not in f.read_text(), f
    sources = sorted((PORT / "csrc").glob("*.cu*")) + \
        sorted((PORT / "native").glob("*.cpp"))
    assert [p.name for p in sources] == [
        "frozen_norm.cu", "pairwise_boxes.cu", "relpos_attention.cu",
        "roi_pool_bf16.cuh",
        "roi_pool_flat.cu",
        "roi_pool_levels.cu", "roi_pool_prep.cu", "roi_pool_resident.cu",
        "roi_pool_window.cuh", "contour.cpp"]
    assert {"compat.py", "cli.py"} <= {f.name for f in files}
    assert PORT / "parallel" / "mesh.py" in files
    assert PORT / "train" / "train.py" in files


@pytest.mark.parametrize("name", ["config.yml", "config_r101.yml"])
def test_config_defaults_and_model_spec_match_jax(name):
    """The example configs load to the same dict, take the same defaults
    and build the same model spec field for field.  One key differs on
    purpose: ``device`` names a torch device in the port.  The port's own
    fields (the ViTDet backbone, the input order) keep the R-FPN model's
    values."""
    import dataclasses
    from treedetection_tpu import config as jax_config
    from treedetection_tpu_torch import config as port_config
    path = str(REPO / "example" / name)
    raw = port_config.load_config(path)
    assert raw == jax_config.load_config(path)
    filled = port_config.apply_defaults(dict(raw))
    for key, default in jax_config._DEFAULTS:
        if key != "device":
            assert filled[key] == raw.get(key, default), key
    ours = port_config.model_spec(filled)
    theirs = jax_config.model_spec(filled)
    shared = {f.name for f in dataclasses.fields(theirs)}
    for field in dataclasses.fields(ours):
        if field.name in shared:
            assert getattr(ours, field.name) == getattr(theirs,
                                                        field.name), \
                field.name
        else:
            assert getattr(ours, field.name) == field.default, field.name
    assert (ours.backbone, ours.input_format) == ("resnet", "BGR")


def test_device_selection():
    assert select_device("cpu") == torch.device("cpu")
    for bad in ("tpu", "gpu0", "cuda:x", 1.5):
        with pytest.raises(ValueError):
            select_device(bad)
    if torch.cuda.is_available():
        assert select_device(None) == torch.device("cuda", 0)
        assert select_device("0") == select_device("cuda:0") == \
            select_device(0) == torch.device("cuda", 0)
    else:
        for req in (None, "cuda", "cuda:0", "0", 0):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                select_device(req)


def test_predictor_defaults_to_cuda():
    """No ``device:`` key -> the Predictor targets CUDA; without a card it
    raises rather than running on the CPU."""
    from treedetection_tpu_torch.prediction import Predictor
    cfg = {k: v for k, v in PRED_CFG.items() if k != "device"}
    if torch.cuda.is_available():
        assert Predictor(cfg, None).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Predictor(cfg, None)
