"""The two-model (urban/forest) configuration of ``process_files`` through
both packages, on the CPU in float32 with shared weights.

The counterpart of ``tests/test_pipeline.py::TestTwoModelEndToEnd`` (slow
there), kept small here: a 100 m raster in 16 unbuffered 25 m tiles,
``model_input_size`` 128, the synthetic detectron2 R50 of ``test_convert``
written once as ``.npz`` and given to both models of both packages.  The
forest outline covers the west half, so the west tiles are forest-only and
the east tiles urban-only.

Tolerances are those of ``tests/test_torch_detection.py``: scores within
5e-4, ring vertices within one raster pixel (0.2 m), crowns matched one to
one as multisets.  The tiles carry no buffer: anchors over a zero-filled
margin tie in RPN score and either package may keep either one.
"""

import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import yaml

from test_torch_detection import (PIXEL, SCORE_TOL, _layer, _match_crowns)
from test_torch_jax_native import jax_native  # noqa: F401 (fixture)
from treedetection_tpu_torch import detection, prediction
from treedetection_tpu_torch.config import Config, prepare_config
from treedetection_tpu_torch.geo import Affine, write_geotiff
from treedetection_tpu_torch.vector.geojson import write_geojson

ORIGIN = (412000.0, 5318000.0)
STEM = "324125317"


def _raw_config(out: str):
    return {"image_directory": "rgb", "height_data_path": "nDSM",
            "urban_model": "urban.npz", "forrest_model": "forest.npz",
            "forrest_outline": "forest.geojson",
            "output_directory": out, "tiles_path": f"{out}_tiles",
            "tile_width": 25, "tile_height": 25, "buffer": 0,
            "batch_size": 3, "use_overlap": False, "num_workers": 2,
            "model_depth": 50, "model_input_size": 128,
            "rpn_pre_nms_topk": 200, "rpn_post_nms_topk": 100,
            "rpn_approx_topk_from": 0, "max_detections": 20,
            "ndvi_mean_threshold": -2.0, "ndvi_var_threshold": 99.0,
            "height_threshold": 0, "mixed_precision": False,
            "keep_intermediate": True, "device": "cpu",
            "compile_warmup": False}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_native):
    """``jax_native``: the JAX side traces with its native library
    (``test_torch_jax_native.py``)."""
    from test_convert import _make_fake_d2_state_dict
    from treedetection_tpu.config import Config as JaxConfig
    from treedetection_tpu.config import get_config as jax_get_config
    from treedetection_tpu.detection import process_files as jax_process_files
    from treedetection_tpu.models.convert import (
        convert_detectron2_state_dict, save_checkpoint_npz)
    root = tmp_path_factory.mktemp("two_model")
    rng = np.random.default_rng(0)
    (root / "rgb").mkdir()
    (root / "nDSM").mkdir()
    write_geotiff(str(root / "rgb" / f"{STEM}.tif"),
                  rng.integers(0, 255, (500, 500, 4), dtype=np.uint8),
                  Affine.from_origin(*ORIGIN, PIXEL, PIXEL), crs=25832)
    write_geotiff(str(root / "nDSM" / f"{STEM}.tif"),
                  (rng.random((100, 100)) * 30).astype(np.float32),
                  Affine.from_origin(*ORIGIN, 1.0, 1.0), crs=25832,
                  nodata=-9999.0)
    # the west half, with margins beyond the raster
    write_geojson(str(root / "forest.geojson"),
                  [np.array([[411990., 5317890.], [412050., 5317890.],
                             [412050., 5318010.], [411990., 5318010.]])],
                  [{}], crs_epsg=25832)
    save_checkpoint_npz(str(root / "urban.npz"), convert_detectron2_state_dict(
        _make_fake_d2_state_dict(depth=50), depth=50))
    shutil.copyfile(root / "urban.npz", root / "forest.npz")
    for name in ("TD_ROI_FLAT", "TD_ROI_RESIDENT", "TD_PAIRS_DEVICE"):
        os.environ.pop(name, None)

    Config.reset()
    config, _ = prepare_config(_raw_config("port"), str(root))
    ours = detection.process_files(config)
    (root / "jax.yml").write_text(yaml.safe_dump(_raw_config("jax")))
    JaxConfig.reset()
    jax_config, _ = jax_get_config(str(root / "jax.yml"))
    theirs = jax_process_files(jax_config)
    for cfg in (config, jax_config):
        for handler in list(cfg["logger"].handlers):
            cfg["logger"].removeHandler(handler)
            handler.close()
    return {"root": root, "config": config, "ours": ours, "theirs": theirs}


def _predicted(root, out, model):
    d = root / out / "predictions" / model / STEM
    return sorted(p.name for p in d.glob("Prediction_*.json"))


def test_tile_flags_route_the_two_passes(runs):
    """Same tile plan and flags in both packages; the urban pass skipped the
    forest-only tiles and the forest pass the urban-only ones."""
    root = runs["root"]
    plan = root / "port_tiles" / f"{STEM}.json"
    assert plan.read_bytes() == (root / "jax_tiles" / f"{STEM}.json").read_bytes()
    meta = json.loads(plan.read_text())
    assert len(meta) == 16
    only_forest = {t for t, m in meta.items() if m["only_forest"]}
    only_urban = {t for t, m in meta.items() if m["only_urban"]}
    assert len(only_forest) == 8 and len(only_urban) == 8
    for model, skipped in (("urban", only_forest), ("forest", only_urban)):
        want = sorted(f"Prediction_{os.path.basename(t)}.json"
                      for t in meta if t not in skipped)
        assert _predicted(root, "port", model) == want
        assert _predicted(root, "jax", model) == want
        assert len(want) == 8


def test_two_predictors_and_two_stitch_entries(runs):
    """One Predictor per model path stays cached on the config, and each
    pass's eager stitch entry was consumed by its own stitch call."""
    cache = runs["config"]["_predictor_cache"]
    assert len(cache) == 2 and len({id(p) for p in cache.values()}) == 2
    assert all(not p.used_random_init for p in cache.values())
    assert not runs["config"].get("_stitch_cache")
    for model in ("urban", "forest"):
        d = runs["root"] / "port" / "predictions" / model
        assert (d / f"{STEM}.gpkg").exists()
        assert (d / "stitching_recovery.yaml").exists()
        assert (d / "prediction_recovery.yaml").exists()


@pytest.mark.parametrize("layer", ["urban", "forest", "fused"])
def test_stitched_and_fused_crowns_match_jax(runs, layer):
    rel = f"predictions/{STEM}.gpkg" if layer == "fused" else \
        f"predictions/{layer}/{STEM}.gpkg"
    ours = _layer(runs["root"] / "port" / rel)
    theirs = _layer(runs["root"] / "jax" / rel)
    assert len(ours) >= 5, "too few crowns: the comparison is vacuous"
    for (_, p), (_, q) in _match_crowns(ours, theirs):
        assert p["Confidence_score"] == pytest.approx(q["Confidence_score"],
                                                      abs=SCORE_TOL)
    xs = np.array([ring[:, 0].mean() for ring, _ in ours])
    seam = ORIGIN[0] + 50.0
    if layer == "urban":
        assert (xs > seam).all()
    elif layer == "forest":
        assert (xs < seam).all()
    else:
        assert (xs < seam).any() and (xs > seam).any()


def test_processed_crowns_match_jax(runs):
    assert [Path(p).name for p in runs["ours"]] == \
        [Path(p).name for p in runs["theirs"]] == [f"processed_{STEM}.gpkg"]
    ours, theirs = _layer(runs["ours"][0]), _layer(runs["theirs"][0])
    assert len(ours) >= 5, "too few processed crowns: vacuous"
    for (ring, p), (_, q) in _match_crowns(ours, theirs):
        assert p["Confidence_score"] == pytest.approx(q["Confidence_score"],
                                                      abs=SCORE_TOL)
        perimeter = np.linalg.norm(np.diff(ring, axis=0), axis=1).sum()
        assert abs(p["Area"] - q["Area"]) <= perimeter * PIXEL
        assert p["is_contained"] == q["is_contained"]
        assert p["num_contained"] == q["num_contained"]


def test_second_two_model_call_predicts_nothing(runs, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the resumed run built a Predictor")
    monkeypatch.setattr(prediction, "Predictor", boom)
    fused = runs["root"] / "port" / "predictions" / f"{STEM}.gpkg"
    before = {p: os.path.getmtime(p) for p in runs["ours"] + [str(fused)]}
    Config.reset()
    config, _ = prepare_config(_raw_config("port"), str(runs["root"]))
    outputs = detection.process_files(config)
    for handler in list(config["logger"].handlers):
        config["logger"].removeHandler(handler)
        handler.close()
    assert outputs == runs["ours"] and "_predictor_cache" not in config
    assert {p: os.path.getmtime(p) for p in before} == before
