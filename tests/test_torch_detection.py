"""The slice as a whole: ``process_files`` of the port against the JAX
package's, on the CPU in float32 with the same trained weights
(``example/data/model_full.npz``) and the same files.

Tolerances.  Tile JSON: the same tiles and crowns in the same order, scores
within 5e-4 (float32 on both sides, but the convolutions sum in another
order, and with the trained weights a logit difference of ~7e-4 near score
0.5, where the sigmoid is steepest, moves the score by 1.8e-4; the synthetic
weights of test_torch_pipeline stay within 1e-4), vertices within one raster
pixel (0.2 m): a uint8 mask value that rounds differently can move a traced
contour by one pixel of the resized mask (and then the tracer may keep one
vertex more or less: such rings are held to the same extent).  Stitched and processed crowns:
equal as multisets under that vertex tolerance (matched one to one),
Confidence_score within 5e-4, Area and
Diameter within what a one-pixel shift of the ring allows (perimeter x
0.2 m), TreeHeight within 0.5 m, the other properties identical except
``poly_id`` (an index into the stitched layer).

The tiles carry no buffer, so every window lies inside the raster: anchors
over a zero-filled margin tie in RPN score and either package may keep
either one."""

import json
import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from test_torch_jax_native import jax_native  # noqa: F401 (fixture)
from treedetection_tpu_torch import detection, prediction, stitching
from treedetection_tpu_torch.config import (Config, get_config,
                                            prepare_config)
from treedetection_tpu_torch.geo import Affine, write_geotiff
from treedetection_tpu_torch.parallel import mesh
from treedetection_tpu_torch.vector import read_gpkg

REPO = Path(__file__).resolve().parents[1]
NPZ = REPO / "example" / "data" / "model_full.npz"
PIXEL = 0.2
SCORE_TOL = 5e-4
ORIGIN = (412000.0, 5318000.0)


def circle(cx, cy, r, n=24):
    a = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([cx + r * np.cos(a), cy + r * np.sin(a)], axis=1)


def _write_rasters(root: Path, side_px=375, n_discs=60, seed=0):
    """RGBI at 0.2 m with crown-like discs (dark red/blue, bright NIR) and a
    1 m nDSM with the discs 5-25 m high."""
    rng = np.random.default_rng(seed)
    h = w = side_px
    img = rng.normal([150, 160, 120, 110], [12, 12, 12, 10],
                     (h, w, 4)).astype(np.float32)
    ndsm = np.zeros((h // 5, w // 5), dtype=np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    myy, mxx = np.mgrid[0:h // 5, 0:w // 5]
    for _ in range(n_discs):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        rad = rng.uniform(2.0, 6.0) / PIXEL
        d2 = ((yy - cy) ** 2 + (xx - cx) ** 2) / rad ** 2
        inside = d2 < 1.0
        shade = 0.55 + 0.3 * d2[inside]
        img[inside, 0] *= shade * 0.6
        img[inside, 1] *= shade * 0.85
        img[inside, 2] *= shade * 0.6
        img[inside, 3] = np.minimum(img[inside, 3] * 1.8, 255)
        md2 = ((myy + 0.5 - cy / 5) ** 2 + (mxx + 0.5 - cx / 5) ** 2) \
            / (rad / 5) ** 2
        ndsm = np.maximum(ndsm, np.where(md2 < 1.0,
                                         rng.uniform(5, 25) * (1 - 0.5 * md2),
                                         0.0).astype(np.float32))
    (root / "rgb").mkdir(parents=True)
    (root / "nDSM").mkdir()
    write_geotiff(str(root / "rgb" / "324125317.tif"),
                  np.clip(img, 0, 255).astype(np.uint8),
                  Affine.from_origin(*ORIGIN, PIXEL, PIXEL), crs=25832)
    write_geotiff(str(root / "nDSM" / "324125317.tif"), ndsm,
                  Affine.from_origin(*ORIGIN, 1.0, 1.0), crs=25832,
                  nodata=-9999.0)


def _raw_config(out: str, **over):
    cfg = {"image_directory": "rgb", "height_data_path": "nDSM",
           "combined_model": str(NPZ), "output_directory": out,
           "tiles_path": f"{out}_tiles",
           # 25 m tiles: 125 px shown to the model at 256, close to the
           # 0.09 m/px the weights were trained at
           "tile_width": 25, "tile_height": 25, "buffer": 0,
           "batch_size": 2, "use_overlap": False, "num_workers": 2,
           "model_depth": 50, "model_input_size": 256,
           "pixel_std": [57.375, 57.12, 58.395],
           "rpn_pre_nms_topk": 300, "rpn_post_nms_topk": 150,
           "rpn_approx_topk_from": 0, "max_detections": 40,
           "ndvi_mean_threshold": 0.1, "ndvi_var_threshold": 0.2,
           "mixed_precision": False, "keep_intermediate": True,
           "device": "cpu", "compile_warmup": False}
    cfg.update(over)
    return cfg


def _run_port(root: Path, out: str, **over):
    Config.reset()
    config, _ = prepare_config(_raw_config(out, **over), str(root))
    try:
        return config, detection.process_files(config)
    finally:
        for handler in list(config["logger"].handlers):
            config["logger"].removeHandler(handler)
            handler.close()


def _run_jax(root: Path, out: str):
    from treedetection_tpu.config import Config as JaxConfig
    from treedetection_tpu.config import get_config as jax_get_config
    from treedetection_tpu.detection import process_files
    path = root / f"{out}.yml"
    path.write_text(yaml.safe_dump(_raw_config(out)))
    JaxConfig.reset()
    config, _ = jax_get_config(str(path))
    return process_files(config)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_native):
    """One port run and one JAX run of ``process_files`` on the same
    rasters; ``jax_native``: the JAX side traces with its native library
    (``test_torch_jax_native.py``)."""
    root = tmp_path_factory.mktemp("slice")
    _write_rasters(root)
    os.environ.pop("TD_PAIRS_DEVICE", None)
    config, ours = _run_port(root, "port")
    theirs = _run_jax(root, "jax")
    return {"root": root, "config": config, "ours": ours, "theirs": theirs}


def _tile_json(root, out):
    d = root / out / "predictions" / "324125317"
    return {p.name: json.loads(p.read_text())
            for p in sorted(d.glob("Prediction_*.json"))}


def _match_crowns(ours, theirs):
    """One-to-one matching of (ring, props) lists: same vertex count and
    every vertex within a pixel.  -> list of (ours, theirs) pairs."""
    assert len(ours) == len(theirs)
    free = list(range(len(theirs)))
    pairs = []
    for ring, props in ours:
        hit = next((k for k in free if theirs[k][0].shape == ring.shape
                    and np.abs(theirs[k][0] - ring).max() <= PIXEL + 1e-6),
                   None)
        assert hit is not None, f"no partner for the crown at {ring.mean(0)}"
        free.remove(hit)
        pairs.append(((ring, props), theirs[hit]))
    return pairs


def _layer(path):
    geoms, props, srs = read_gpkg(str(path))
    assert srs == 25832
    return [(np.asarray(g[0][0]), p) for g, p in zip(geoms, props)]


def test_tile_json_matches_jax(runs):
    got, want = _tile_json(runs["root"], "port"), _tile_json(runs["root"], "jax")
    assert sorted(got) == sorted(want) and len(got) == 9
    n = 0
    for name in want:
        assert len(got[name]) == len(want[name]), name
        for g, w in zip(got[name], want[name]):
            assert abs(g["score"] - w["score"]) < SCORE_TOL
            gp = np.asarray(g["polygon_coords"][0])
            wp = np.asarray(w["polygon_coords"][0])
            if gp.shape == wp.shape:
                assert np.abs(gp - wp).max() <= PIXEL + 1e-6, name
            else:   # a contour pixel moved: compare the rings' extents
                assert np.abs(gp.min(0) - wp.min(0)).max() <= PIXEL + 1e-6
                assert np.abs(gp.max(0) - wp.max(0)).max() <= PIXEL + 1e-6
            n += 1
    assert n >= 10, "too few crowns: the comparison is vacuous"


def test_stitched_crowns_match_jax(runs):
    ours = _layer(runs["root"] / "port" / "predictions" / "324125317.gpkg")
    theirs = _layer(runs["root"] / "jax" / "predictions" / "324125317.gpkg")
    assert len(ours) >= 8
    for (_, p), (_, q) in _match_crowns(ours, theirs):
        assert p["Confidence_score"] == pytest.approx(q["Confidence_score"],
                                                      abs=SCORE_TOL)


def test_processed_crowns_match_jax(runs):
    assert [Path(p).name for p in runs["ours"]] == \
        [Path(p).name for p in runs["theirs"]] == ["processed_324125317.gpkg"]
    ours, theirs = _layer(runs["ours"][0]), _layer(runs["theirs"][0])
    assert len(ours) >= 5, "too few processed crowns: vacuous"
    for (ring, p), (_, q) in _match_crowns(ours, theirs):
        assert set(p) == set(q) == {
            "Confidence_score", "poly_id", "Area", "TreeHeight", "Centroid",
            "Diameter", "is_contained", "num_contained"}
        assert p["Confidence_score"] == pytest.approx(q["Confidence_score"],
                                                      abs=SCORE_TOL)
        perimeter = np.linalg.norm(np.diff(ring, axis=0), axis=1).sum()
        assert abs(p["Area"] - q["Area"]) <= perimeter * PIXEL
        assert p["Diameter"] == pytest.approx(q["Diameter"], rel=0.1)
        assert p["TreeHeight"] == pytest.approx(q["TreeHeight"], abs=0.5)
        assert p["TreeHeight"] >= 3
        assert p["is_contained"] == q["is_contained"]
        assert p["num_contained"] == q["num_contained"]


def test_layout_and_manifests(runs):
    root = runs["root"]
    meta = json.loads((root / "port_tiles" / "324125317.json").read_text())
    assert len(meta) == 9
    assert (root / "port_tiles" / "324125317.json").read_bytes() == \
        (root / "jax_tiles" / "324125317.json").read_bytes()
    for name in ("port_tiles/recovery.yaml",
                 "port/predictions/prediction_recovery.yaml",
                 "port/predictions/stitching_recovery.yaml",
                 "port/recovery.yaml"):
        ours = yaml.safe_load((root / name).read_text())
        theirs = yaml.safe_load(
            (root / name.replace("port", "jax", 1)).read_text())
        swap = json.loads(json.dumps(theirs).replace("/jax", "/port"))
        assert ours == swap, name
    assert set(detection.LAST_STAGE_SECONDS) == {
        "preprocess", "predict", "postprocess", "cleanup", "total"}


def test_second_call_predicts_nothing(runs, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the resumed run built a Predictor")
    monkeypatch.setattr(prediction, "Predictor", boom)
    before = {p: os.path.getmtime(p) for p in runs["ours"]}
    config, outputs = _run_port(runs["root"], "port")
    assert outputs == runs["ours"]
    assert "_predictor_cache" not in config
    assert {p: os.path.getmtime(p) for p in outputs} == before


@pytest.mark.parametrize("variant", ["no_eager_stitch", "staged",
                                     "pairs_device"])
def test_variants_equal_the_default_run(runs, variant, monkeypatch):
    """``eager_stitch: False`` (the stitch stage re-parses the JSON files),
    the staged pipeline (``overlap_postprocess: False``) and the kernel
    branch of the pair relation give the default run's layers."""
    over = {"no_eager_stitch": {"eager_stitch": False},
            "staged": {"overlap_postprocess": False},
            "pairs_device": {}}[variant]
    if variant == "pairs_device":
        monkeypatch.setenv("TD_PAIRS_DEVICE", "1")
    config, outputs = _run_port(runs["root"], variant, **over)
    if variant == "no_eager_stitch":
        assert not config.get("_stitch_cache")
    for rel in ("predictions/324125317.gpkg", "processed_324125317.gpkg"):
        a = _layer(runs["root"] / "port" / rel)
        b = _layer(runs["root"] / variant / rel)
        assert len(a) == len(b) > 0
        for (ra, pa), (rb, pb) in zip(a, b):
            np.testing.assert_array_equal(ra, rb)
            assert pa == pb


def test_cleanup_removes_intermediates(runs):
    _, outputs = _run_port(runs["root"], "clean", keep_intermediate=False)
    root = runs["root"]
    assert [Path(p).name for p in outputs] == ["processed_324125317.gpkg"]
    assert os.path.exists(outputs[0])
    assert not (root / "clean_tiles").exists()
    assert not (root / "clean" / "predictions").exists()


def _write_prediction_json(path, crowns_scores):
    data = [{"image_id": "x.tif", "category_id": 0, "score": s,
             "polygon_coords": [np.asarray(c).tolist()]}
            for c, s in crowns_scores]
    Path(path).write_text(json.dumps(data))


@pytest.mark.parametrize("case", ["sink_matches_files", "tolerance_mismatch",
                                  "write_failure", "stale_dir"])
def test_eager_sink_and_its_fallbacks(tmp_path, monkeypatch, case):
    """The Predictor's in-memory stitch sink gives the file path's GPKG, and
    is distrusted when its tolerance differs, when writing from it fails, or
    when it does not cover the JSON files on disk."""
    root = tmp_path / "pred"
    d = root / "img"
    d.mkdir(parents=True)
    rng = np.random.default_rng(3)
    names = []
    for tx in (100, 150):
        tile_id = f"img_{tx}_200_50_20_25832"
        crowns = [(circle(tx + rng.uniform(-10, 60), 200 + rng.uniform(-10, 60),
                          rng.uniform(2, 6), n=40),
                   float(rng.uniform(0.3, 1.0))) for _ in range(5)]
        names.append(f"Prediction_{tile_id}.json")
        _write_prediction_json(d / names[-1], crowns)
    out_file = str(tmp_path / "file.gpkg")
    n_file = stitching.stitch_image(str(d), out_file, 0.2)
    tiles = {n: stitching.stitch_tile_file(str(d / n), 0.2) for n in names}
    entry = {"tolerance": 0.2, "tiles": tiles}
    tolerance = 0.2
    if case == "tolerance_mismatch":
        entry = {"tolerance": 0.5, "tiles": {n: ([], []) for n in names}}
    elif case == "write_failure":
        monkeypatch.setattr(stitching, "stitch_image_cached",
                            lambda *a, **kw: (_ for _ in ()).throw(
                                ValueError("bad write")))
    elif case == "stale_dir":
        entry = {"tolerance": 0.2, "tiles": {names[0]: ([], [])}}
    config = {"logger": None, "simplify_tolerance": tolerance,
              "_stitch_cache": {str(d): entry}}
    outputs = stitching.process_and_stitch_predictions(config, str(root),
                                                       ["img.tif"])
    assert config["_stitch_cache"] == {}                  # consumed
    got, want = _layer(outputs[0]), _layer(out_file)
    assert len(got) == n_file == len(want) > 0
    for (ra, pa), (rb, pb) in zip(got, want):
        np.testing.assert_array_equal(ra, rb)
        assert pa == pb


def test_stitch_stage_survives_one_bad_image(tmp_path, monkeypatch):
    from treedetection_tpu_torch.recoveries import load_stitching_recovery_data
    root = tmp_path / "pred"
    for stem in ("good", "bad"):
        (root / stem).mkdir(parents=True)
        _write_prediction_json(
            root / stem / f"Prediction_{stem}_100_200_50_20_25832.json",
            [(circle(125, 225, 5), 0.9)])
    real = stitching.stitch_image

    def flaky(pred_dir, out_gpkg, *a, **kw):
        if "bad" in pred_dir:
            raise OSError("disk full")
        return real(pred_dir, out_gpkg, *a, **kw)

    monkeypatch.setattr(stitching, "stitch_image", flaky)
    outputs = stitching.process_and_stitch_predictions(
        {"logger": None}, str(root), ["good.tif", "bad.tif"])
    assert len(outputs) == 2 and os.path.exists(root / "good.gpkg")
    assert set(load_stitching_recovery_data(str(root))) == {"good"}


def test_get_predictor_builds_once_under_a_race(monkeypatch):
    built = []

    class SlowStub:
        def __init__(self, config, model_path):
            time.sleep(0.05)
            built.append(self)

    monkeypatch.setattr(prediction, "Predictor", SlowStub)
    config, results = {}, [None] * 4

    def grab(i):
        results[i] = prediction.get_predictor(config, "m.npz")

    threads = [threading.Thread(target=grab, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(built) == 1 and all(r is built[0] for r in results)
    assert prediction.get_predictor(config, "other.npz") is not built[0]


def test_cli_runs_the_stages(runs, capsys, monkeypatch, tmp_path):
    """``cli.main`` drives each ported stage from a YAML config (here on the
    finished run, so every stage resumes from its manifest) and prints the
    stage's outputs; ``bench`` without CUDA exits with code 2 and names it,
    printing no result; ``eval``, ``voronoi`` and ``autolabel`` fail
    on inputs that do not exist as the JAX package's CLI does."""
    import logging
    from treedetection_tpu_torch import cli
    from treedetection_tpu_torch.config import LOGGER_NAME

    def boom(*a, **k):
        raise AssertionError("the resumed run built a Predictor")
    monkeypatch.setattr(prediction, "Predictor", boom)
    path = runs["root"] / "cli.yml"
    path.write_text(yaml.safe_dump(_raw_config("port")))
    printed = {}
    for command in ("preprocess", "predict", "postprocess", "run"):
        Config.reset()
        assert cli.main([command, str(path)]) == 0
        # the console log handler writes to stdout too: keep the paths
        printed[command] = [ln for ln in capsys.readouterr().out.splitlines()
                            if ln.startswith(os.sep)]
    logger = logging.getLogger(LOGGER_NAME)
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    assert printed["run"] == printed["postprocess"] == runs["ours"]
    assert [Path(p).name for p in printed["predict"]] == ["324125317.gpkg"]
    assert [Path(p).name for p in printed["preprocess"]] == ["324125317.json"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["bench"]) == 2
    said = capsys.readouterr()
    assert "CUDA is not available" in said.err and said.out == ""
    from treedetection_tpu import cli as jax_cli
    gone = str(tmp_path / "missing")
    for argv in (["eval", gone + ".gpkg", gone + "_gt.gpkg"],
                 ["voronoi", gone + ".tif", str(tmp_path / "out.gpkg")],
                 ["autolabel", gone, gone + "_ann", str(tmp_path / "out")]):
        raised = []
        for main in (cli.main, jax_cli.main):
            with pytest.raises(Exception) as info:
                main(argv)
            raised.append(type(info.value))
        assert raised[0] is raised[1], (argv, raised)


def test_unported_branches_raise(tmp_path, monkeypatch):
    """No branch of the port raises ``NotImplementedError`` any more: more
    than one host runs (a host with no image predicts and fuses nothing),
    and so do two-model routing and RLE prediction files.  The default
    device raises without a card."""
    from treedetection_tpu_torch.compat import rle_encode
    from treedetection_tpu_torch.vector.geojson import write_geojson
    outline = str(tmp_path / "forest.geojson")
    write_geojson(outline, [circle(0, 0, 50)], [{}], crs_epsg=25832)
    two = {"urban_model": "u", "forrest_model": "f",
           "forrest_outline": outline, "tiles_path": str(tmp_path / "tiles"),
           "image_directory": str(tmp_path), "height_data_path": str(tmp_path),
           "output_directory": str(tmp_path / "out")}
    monkeypatch.setenv("TREEDETECTION_NUM_HOSTS", "2")
    monkeypatch.setenv("TREEDETECTION_HOST_ID", "1")
    assert mesh.current_num_hosts() == 2
    assert detection.predict_tiles(two) == []
    monkeypatch.delenv("TREEDETECTION_NUM_HOSTS")
    monkeypatch.delenv("TREEDETECTION_HOST_ID")
    port = Path(detection.__file__).parent
    raising = [f.name for f in sorted(port.rglob("*.py"))
               if "raise NotImplementedError" in f.read_text()]
    assert raising == []
    # two-model routing runs: with no image it predicts and fuses nothing
    assert detection.predict_tiles(two) == []
    assert (tmp_path / "out" / "predictions" / "urban").is_dir()
    assert (tmp_path / "out" / "predictions" / "forest").is_dir()
    # an RLE crown (a 20 x 20 px square) is decoded, traced and kept
    mask = np.zeros((60, 60), dtype=np.uint8)
    mask[20:40, 10:30] = 1
    rle = tmp_path / "Prediction_img_0_0_60_0_25832.json"
    rle.write_text(json.dumps([{"score": 0.9,
                                "segmentation": rle_encode(mask)}]))
    crowns, scores = stitching.stitch_tile_file(str(rle), 0.2)
    assert scores == [0.9] and len(crowns) == 1
    assert crowns[0][:, 0].min() >= 9 and crowns[0][:, 0].max() <= 31
    assert crowns[0][:, 1].min() >= 19 and crowns[0][:, 1].max() <= 41
    if not torch.cuda.is_available():
        _write_rasters(tmp_path / "data", side_px=50, n_discs=1)
        raw = _raw_config("out")
        del raw["device"]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            prepare_config(raw, str(tmp_path / "data"))


def test_get_config_equals_prepare_config(tmp_path):
    """``get_config(path)`` is ``load_config`` + ``prepare_config``: the
    same keys and values as the JAX package's get_config, less the device
    keys, the logger and the TPU-only keys."""
    from treedetection_tpu.config import get_config as jax_get_config
    _write_rasters(tmp_path, side_px=50, n_discs=1)
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(_raw_config("out")))
    ours, obj = get_config(str(path))
    theirs, _ = jax_get_config(str(path))
    assert ours["device"] == torch.device("cpu")
    assert obj.tile_width == 25 and ours["continue"].endswith("continue.yml")
    skip = {"device", "devices", "num_devices", "logger",
            "compilation_cache_dir"}
    assert {k: v for k, v in ours.items() if k not in skip} == \
        {k: v for k, v in theirs.items() if k not in skip}
    for config in (ours, theirs):
        for handler in list(config["logger"].handlers):
            config["logger"].removeHandler(handler)
            handler.close()
    with pytest.raises(AssertionError, match="image_directory"):
        prepare_config({"height_data_path": str(tmp_path)}, str(tmp_path))


@pytest.mark.parametrize("depth", [50, 101])
def test_pth_reader_matches_jax_tensor_by_tensor(tmp_path, depth):
    """A synthetic detectron2 state dict through the port's ``.pth`` reader
    and through the JAX package's ``load_checkpoint`` carried across by
    ``from_flax_params``: the same keys and bit-identical tensors, and the
    model loads them strictly."""
    from test_convert import _make_fake_d2_state_dict
    from treedetection_tpu.models.convert import (
        load_checkpoint as jax_load_checkpoint)
    from treedetection_tpu_torch.models.convert import (from_flax_params,
                                                        load_checkpoint)
    from treedetection_tpu_torch.models.mask_rcnn import (MaskRCNN,
                                                          MaskRCNNConfig)
    path = str(tmp_path / "model.pth")
    torch.save({"model": _make_fake_d2_state_dict(depth=depth)}, path)
    ours = load_checkpoint(path, depth=depth)
    theirs = from_flax_params(jax_load_checkpoint(path, depth=depth))
    assert sorted(ours) == sorted(theirs)
    for key in theirs:
        assert ours[key].dtype == torch.float32
        assert torch.equal(ours[key], theirs[key]), key
    MaskRCNN(MaskRCNNConfig(depth=depth, input_size=128)).load_state_dict(
        ours, strict=True)
    with pytest.raises(ValueError, match="unsupported checkpoint"):
        load_checkpoint(str(tmp_path / "model.ckpt"))
