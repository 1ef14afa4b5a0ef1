"""The run's first-use work in the port against the JAX package, on the CPU
at small sizes: ``prediction.expected_pad`` (equal to JAX's and to the pad
``Predictor._plan`` produces), ``start_compile_warmup`` (None exactly where
JAX's is; otherwise one warm-up of the first model at the expected pad),
``Predictor.warmup`` inside ``process_files`` (one Predictor, the same
crowns with the warm-up on and off, a failed warm-up logged and the run
finished), one long-lived thread per device entry (``parallel.mesh``), the
``compile_s`` stat, and the two names ported beside them
(``MaskRCNNConfig.dtype``, ``ops.boxes.transform_pixel_to_geo``).

On the JAX side only the ``None`` cases of ``start_compile_warmup`` run, so
that no JAX model compiles here."""

import logging
import shutil
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_detection import NPZ, _raw_config, _write_rasters  # noqa: E402
from treedetection_tpu_torch import detection, prediction, recoveries  # noqa: E402
from treedetection_tpu_torch.config import Config, prepare_config  # noqa: E402
from treedetection_tpu_torch.geo import Affine, GeoTiff, write_geotiff  # noqa: E402
from treedetection_tpu_torch.parallel import mesh  # noqa: E402
from treedetection_tpu_torch.preprocessing import (  # noqa: E402
    load_tile_metadata, tile_single_file)
from treedetection_tpu_torch.vector import read_gpkg  # noqa: E402

TIMEOUT_S = 60
STEM, SECOND = "324125317", "324135317"


# --- expected_pad ---------------------------------------------------------------

RASTERS = {   # pixel size (m) -> (side px, origin); origins off the metre grid
    0.2: (375, (412000.3, 5318000.1)),
    1.0: (120, (412003.0, 5318007.0))}
TILINGS = [{"tile_width": 50, "tile_height": 50, "buffer": 20},
           {"tile_width": 25, "tile_height": 25, "buffer": 0},
           {"tile_width": 30, "tile_height": 40, "buffer": 5},
           {"tile_width": 45, "buffer": 3}]


@pytest.mark.parametrize("tiling", TILINGS, ids=lambda t: "-".join(
    f"{k[5]}{v}" for k, v in t.items()))
@pytest.mark.parametrize("pixel", sorted(RASTERS))
def test_expected_pad_matches_jax_and_plan(tmp_path, pixel, tiling):
    from treedetection_tpu.prediction import expected_pad as jax_expected_pad
    side, origin = RASTERS[pixel]
    tif = tmp_path / "rgb.tif"
    rng = np.random.default_rng(int(pixel * 10))
    write_geotiff(str(tif), rng.integers(0, 255, (side, side, 3),
                                         dtype=np.uint8),
                  Affine.from_origin(*origin, pixel, pixel), crs=25832)
    got = prediction.expected_pad(str(tif), tiling)
    assert got == jax_expected_pad(str(tif), tiling)
    meta = tile_single_file(
        str(tif), str(tmp_path / "tiles"), buffer=tiling["buffer"],
        tile_width=tiling["tile_width"],
        tile_height=tiling.get("tile_height", tiling["tile_width"]))
    items = list(load_tile_metadata(meta).values())
    with GeoTiff(str(tif)) as src:
        _, pad = prediction.Predictor._plan(src, items)
    assert got == pad


# --- start_compile_warmup -------------------------------------------------------

def _warmup_config(root: Path, two_model=False, **over):
    cfg = {"image_directory": str(root / "rgb"),
           "output_directory": str(root / "out"),
           "tile_width": 25, "tile_height": 25, "buffer": 0}
    if two_model:
        cfg.update(urban_model=str(root / "urban.npz"),
                   forrest_model=str(root / "forest.npz"),
                   forrest_outline=str(root / "forest.geojson"))
    else:
        cfg["combined_model"] = str(NPZ)
    cfg.update(over)
    return cfg


def _recovered(root: Path, cfg, images):
    """A prediction manifest (the urban one for two models) that covers
    ``images``, each with one tile file."""
    pred_root = root / "out" / "predictions"
    model = cfg.get("urban_model") or cfg["combined_model"]
    if "urban_model" in cfg:
        pred_root = pred_root / "urban"
    for img in images:
        tiles = pred_root / Path(img).stem
        tiles.mkdir(parents=True)
        (tiles / "Prediction_0_0.json").write_text("[]")
    recoveries.save_prediction_recovery_data(str(pred_root), model, images)


def _image_dir(root: Path, names=(STEM,)):
    (root / "rgb").mkdir(parents=True, exist_ok=True)
    for name in names:
        write_geotiff(str(root / "rgb" / f"{name}.tif"),
                      np.zeros((50, 50, 3), np.uint8),
                      Affine.from_origin(412000.0, 5318000.0, 0.2, 0.2),
                      crs=25832)
    return sorted(str(p) for p in (root / "rgb").glob("*.tif"))


@pytest.mark.parametrize("case", ["off", "no_images", "recovered",
                                  "recovered_by_name",
                                  "recovered_two_model"])
def test_start_compile_warmup_returns_none_where_jax_does(tmp_path, case,
                                                          monkeypatch):
    from treedetection_tpu.prediction import start_compile_warmup as jax_start
    built = []
    monkeypatch.setattr(prediction, "get_predictor",
                        lambda *a: built.append(a))
    cfg = _warmup_config(tmp_path, two_model=case.endswith("two_model"),
                         compile_warmup=case != "off")
    images = _image_dir(tmp_path) if case != "no_images" else []
    if case == "no_images":
        (tmp_path / "rgb").mkdir()
    if case.startswith("recovered"):
        _recovered(tmp_path, cfg, [Path(p).name if case.endswith("name")
                                   else p for p in images])
    assert jax_start(dict(cfg)) is None
    assert prediction.start_compile_warmup(cfg) is None
    assert "_warmup_thread" not in cfg and not built


@pytest.mark.parametrize("two_model", [False, True])
def test_start_compile_warmup_warms_the_first_model_at_the_expected_pad(
        tmp_path, monkeypatch, two_model):
    """Otherwise one daemon thread, published on the config, warms the
    first model (urban for two models) at the first image's pad; a manifest
    that covers only some images does not stop it."""
    warmed = []

    class Stub:
        def warmup(self, pad):
            warmed.append((threading.current_thread().name, pad))

    monkeypatch.setattr(prediction, "get_predictor",
                        lambda config, path: warmed.append(path) or Stub())
    cfg = _warmup_config(tmp_path, two_model=two_model)
    images = _image_dir(tmp_path, (STEM, SECOND))
    _recovered(tmp_path, cfg, images[:1])
    t = prediction.start_compile_warmup(cfg)
    t.join(TIMEOUT_S)
    assert not t.is_alive() and t.daemon and cfg["_warmup_thread"] is t
    model = cfg["urban_model"] if two_model else cfg["combined_model"]
    assert warmed == [model, ("td-compile-warmup",
                              prediction.expected_pad(images[0], cfg))]


# --- process_files with the warm-up ---------------------------------------------

@pytest.fixture(scope="module")
def two_images(tmp_path_factory):
    """Two 50 m rasters (4 tiles of 25 m each, 2 batches of 2) with their
    nDSMs, far enough apart that no seam strip is cut."""
    root = tmp_path_factory.mktemp("warmup")
    _write_rasters(root, side_px=250, n_discs=25, seed=0)
    other = tmp_path_factory.mktemp("warmup_second")
    _write_rasters(other, side_px=250, n_discs=25, seed=1)
    for sub in ("rgb", "nDSM"):
        shutil.move(str(other / sub / f"{STEM}.tif"),
                    str(root / sub / f"{SECOND}.tif"))
    return root


def _run(root: Path, out: str, handler=None, **over):
    Config.reset()
    config, _ = prepare_config(_raw_config(out, **over), str(root))
    if handler is not None:
        config["logger"].addHandler(handler)
    try:
        return config, detection.process_files(config)
    finally:
        for h in list(config["logger"].handlers):
            config["logger"].removeHandler(h)
            h.close()


def _crowns(outputs):
    layers = {}
    for p in outputs:
        geoms, props, _ = read_gpkg(p)
        layers[Path(p).name] = sorted(
            (np.round(np.asarray(g[0][0]), 6).tolist(),
             sorted((k, v) for k, v in p_.items() if k != "poly_id"))
            for g, p_ in zip(geoms, props))
    return layers


@pytest.fixture(scope="module")
def warm_runs(two_images):
    """``process_files`` over the two images with the warm-up off, then on;
    every ``_forward_chunk`` call of the second run recorded with its
    thread and whether its batch was all zeros (the warm-up's)."""
    off = _run(two_images, "off")
    calls = []
    original = prediction.Predictor._forward_chunk

    def recorded(self, model, device, raw, pad):
        calls.append((threading.get_ident(), bool((raw == 0).all()), pad))
        return original(self, model, device, raw, pad)

    prediction.Predictor._forward_chunk = recorded
    try:
        on = _run(two_images, "on", compile_warmup=True)
        stats = dict(prediction.LAST_RUN_STATS)
    finally:
        prediction.Predictor._forward_chunk = original
    return {"off": off, "on": on, "calls": calls, "stats": stats}


def test_the_warmup_warms_the_predictor_the_predict_stage_uses(warm_runs):
    config, _ = warm_runs["on"]
    thread = config["_warmup_thread"]
    assert not thread.is_alive()
    pred = prediction.get_predictor(config, config["combined_model"])
    assert config["_predictor_cache"] == {str(NPZ): pred}
    pad = prediction.expected_pad(
        str(Path(config["image_directory"]) / f"{STEM}.tif"), config)
    assert list(pred._warm_pads) == [pad] and pred._warm_pads[pad] > 0
    assert "_warmup_thread" not in warm_runs["off"][0]


def test_every_forward_runs_on_the_one_device_thread(warm_runs):
    """Two images' batches and the warm-up's forward: one thread, the
    process's thread of the CPU device, not the warm-up thread."""
    calls = warm_runs["calls"]
    assert [zero for _, zero, _ in calls].count(True) == 1
    assert len(calls) == 1 + 2 * 2        # the warm-up + 2 batches per image
    cpu_thread = mesh.device_executor("cpu").submit(
        threading.get_ident).result(TIMEOUT_S)
    assert {ident for ident, _, _ in calls} == {cpu_thread}


def test_the_warmup_changes_no_crown(warm_runs):
    off, on = _crowns(warm_runs["off"][1]), _crowns(warm_runs["on"][1])
    assert sorted(off) == sorted(on) == [f"processed_{STEM}.gpkg",
                                         f"processed_{SECOND}.gpkg"]
    assert sum(len(v) for v in on.values()) > 0
    assert on == off


def test_compile_s_is_the_first_dispatch(warm_runs):
    stats = warm_runs["stats"]
    assert stats["batches"] == 2 and stats["compile_s"] > 0
    assert stats["dispatch_s"] > 0
    assert set(stats) >= {"compile_s", "dispatch_s", "fetch_s", "flush_s",
                          "wall_s"}


def test_a_failed_warmup_is_logged_and_the_run_goes_on(two_images,
                                                       monkeypatch):
    def boom(self, pad):
        raise RuntimeError("warm-up failure under test")

    monkeypatch.setattr(prediction.Predictor, "warmup", boom)
    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    config, outputs = _run(two_images, "failed", handler=handler,
                           compile_warmup=True)
    assert not config["_warmup_thread"].is_alive()
    assert any("Compile warmup failed" in r.getMessage()
               and "warm-up failure under test" in r.getMessage()
               for r in records)
    crowns = _crowns(outputs)
    assert len(crowns) == 2 and sum(len(v) for v in crowns.values()) > 0


# --- one thread per device entry -------------------------------------------------

def _thread_of(fn_calls):
    def fn(replica, device, chunk, scale):
        fn_calls.append((threading.get_ident(), replica, int(chunk[0])))
        return chunk * scale
    return fn


def test_each_device_entry_runs_its_chunks_on_its_own_thread():
    calls = []
    devices = [torch.device("cpu"), torch.device("cpu")]
    forward = mesh.sharded_forward(_thread_of(calls), ["a", "b"], devices)
    threads = [mesh.device_executor("cpu", slot).submit(
        threading.get_ident).result(TIMEOUT_S) for slot in (0, 1)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=16) as callers:
            futures = [callers.submit(forward, torch.arange(4) + 10 * i, 2)
                       for i in range(64)]
            outs = [f.result(TIMEOUT_S) for f in futures]
    finally:
        sys.setswitchinterval(old)
    for i, parts in enumerate(outs):
        assert [p[1] for p in parts] == [None, None]
        assert torch.cat([p[0] for p in parts]).tolist() == [
            2 * (10 * i + k) for k in range(4)]
    by_replica = {r: {ident for ident, r_, _ in calls if r_ == r}
                  for r in "ab"}
    assert by_replica == {"a": {threads[0]}, "b": {threads[1]}}
    assert len(calls) == 2 * 64


def test_a_forward_over_several_devices_is_not_run_on_a_device_thread():
    devices = [torch.device("cpu"), torch.device("cpu")]
    forward = mesh.sharded_forward(_thread_of([]), ["a", "b"], devices)
    with pytest.raises(RuntimeError, match="device thread"):
        mesh.device_executor("cpu").submit(
            forward, torch.arange(4), 1).result(TIMEOUT_S)
    parts = mesh.dispatch_executor(devices).submit(
        forward, torch.arange(4), 1).result(TIMEOUT_S)
    assert torch.cat([p[0] for p in parts]).tolist() == [0, 1, 2, 3]


def test_one_device_runs_on_its_thread_from_any_caller():
    calls = []
    forward = mesh.sharded_forward(_thread_of(calls), ["a"],
                                   [torch.device("cpu")])
    thread = mesh.device_executor("cpu").submit(
        threading.get_ident).result(TIMEOUT_S)
    forward(torch.arange(2), 1)
    mesh.dispatch_executor([torch.device("cpu")]).submit(
        forward, torch.arange(2), 1).result(TIMEOUT_S)
    assert mesh.dispatch_executor(["cpu"]) is mesh.device_executor("cpu")
    assert [ident for ident, _, _ in calls] == [thread, thread]


# --- the two names ported beside the warm-up -------------------------------------

@pytest.mark.parametrize("bf16", [False, True])
def test_mask_rcnn_config_dtype_matches_jax(bf16):
    from treedetection_tpu.models import MaskRCNNConfig as JaxConfig
    from treedetection_tpu_torch.models.mask_rcnn import MaskRCNNConfig
    want = JaxConfig(bf16=bf16).dtype
    got = MaskRCNNConfig(bf16=bf16).dtype
    assert got == (torch.bfloat16 if bf16 else torch.float32)
    assert str(got).replace("torch.", "") == jnp.dtype(want).name


def test_transform_pixel_to_geo_matches_jax():
    from treedetection_tpu.ops.boxes import transform_pixel_to_geo as jax_fn
    from treedetection_tpu_torch.ops.boxes import transform_pixel_to_geo
    rng = np.random.default_rng(5)
    # whole pixels and half-metre scales: every product and sum fits the
    # 24 bits of a float32 mantissa, whichever order or fusion computes it
    coords = rng.integers(0, 5000, (3, 7, 2)).astype(np.float32)
    for affine in ([0.5, 0.0, 412000.0, 0.0, -0.5, 5318000.0],
                   [0.5, 0.5, 412000.0, -0.5, -0.5, 5318000.0]):
        a = np.asarray(affine, np.float32)
        want = np.asarray(jax_fn(jnp.asarray(coords), jnp.asarray(a)))
        got = transform_pixel_to_geo(torch.from_numpy(coords),
                                     torch.from_numpy(a)).numpy()
        assert got.shape == want.shape == (3, 7, 2)
        np.testing.assert_array_equal(got, want)
