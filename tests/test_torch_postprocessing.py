"""The port's crown filter against the JAX package's, on the CPU, from the
same numpy inputs.

Tolerances: pair sets, kept geometries and integer/bool/string properties
identical; float properties within 1e-5 relative + 1e-6 (the raster stats
sum in another order)."""

import json

import numpy as np
import pytest

from treedetection_tpu import postprocessing as jp
from treedetection_tpu.geo import Affine as JaxAffine
from treedetection_tpu_torch import postprocessing as tp
from treedetection_tpu_torch.geo import Affine
from treedetection_tpu_torch.vector import read_gpkg, write_gpkg

OX, OY = 412000.0, 5317000.0          # UTM magnitudes


def square(x0, y0, size):
    return np.array([[x0, y0], [x0 + size, y0], [x0 + size, y0 + size],
                     [x0, y0 + size]], dtype=np.float64)


def circle(cx, cy, r, n=24):
    a = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([cx + r * np.cos(a), cy + r * np.sin(a)], axis=1)


def _config(**over):
    cfg = {"confidence_threshold": 0.3, "containment_threshold": 0.9,
           "height_threshold": 3, "ndvi_mean_threshold": 0.1,
           "ndvi_var_threshold": 0.1, "iou_threshold": 0.5,
           "area_threshold": 1, "ndvi_scaling_factor": 1.0,
           "height_scaling_factor": 1.0, "use_overlap": False,
           "tile_width": 50, "tile_height": 50, "buffer": 20,
           "overlapping_tiles_width": 3, "overlapping_tiles_height": 3,
           "logger": None, "device": "cpu"}
    cfg.update(over)
    return cfg


def _pairs(i, j):
    return sorted(zip(np.asarray(i).tolist(), np.asarray(j).tolist()))


def _seeded_bounds(n, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 9.0 * np.sqrt(n), (n, 2))
    wh = rng.uniform(2, 30, (n, 2))
    bounds = np.concatenate([c - wh / 2, c + wh / 2], axis=1)
    bounds[:n // 10] = bounds[n // 10:2 * (n // 10)] + 0.05   # near-duplicates
    inner = slice(2 * (n // 10), 3 * (n // 10))               # contained boxes
    bounds[inner, :2] = bounds[:n // 10, :2] + 0.5
    bounds[inner, 2:] = bounds[inner, :2] + 1.5
    areas = ((bounds[:, 2] - bounds[:, 0]) * (bounds[:, 3] - bounds[:, 1])
             * rng.uniform(0.6, 1.0, n))
    return bounds.astype(np.float32), areas.astype(np.float32)


@pytest.mark.parametrize("device_branch", ["0", "1"])
@pytest.mark.parametrize("kind", ["dedupe", "containment"])
def test_sparse_relation_pairs_match_jax(monkeypatch, kind, device_branch):
    """Both branches, both kinds: the same pair sets as the JAX package,
    and a small row block so the streamed branch really streams."""
    import torch
    monkeypatch.setenv("TD_PAIRS_DEVICE", device_branch)
    bounds, areas = _seeded_bounds(400)
    thr = 0.5 if kind == "dedupe" else 0.9
    kw = {"areas": areas} if kind == "dedupe" else {}
    tp.PAIR_KERNEL_CALLS.clear()
    ours = tp._sparse_relation_pairs(kind, bounds, thr, block=96,
                                     device=torch.device("cpu"), **kw)
    theirs = jp._sparse_relation_pairs(kind, bounds, thr, block=96, **kw)
    assert _pairs(*ours) == _pairs(*theirs)
    assert len(ours[0]) > 20, "want a non-trivial relation"
    assert tp.PAIR_KERNEL_CALLS == ([(kind, 400, 5)] if device_branch == "1"
                                    else [])


def test_sparse_relation_pairs_branches_agree_and_empty(monkeypatch):
    import torch
    bounds, areas = _seeded_bounds(300, seed=3)
    got = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("TD_PAIRS_DEVICE", flag)
        got[flag] = (
            _pairs(*tp._sparse_relation_pairs(
                "dedupe", bounds, 0.5, areas=areas,
                device=torch.device("cpu"))),
            _pairs(*tp._sparse_relation_pairs(
                "containment", bounds, 0.9, device=torch.device("cpu"))))
        empty = tp._sparse_relation_pairs("dedupe", bounds[:0], 0.5,
                                          areas=areas[:0],
                                          device=torch.device("cpu"))
        assert len(empty[0]) == 0 and len(empty[1]) == 0
    assert got["0"] == got["1"]
    monkeypatch.setenv("TD_PAIRS_DEVICE", "1")
    with pytest.raises(ValueError):
        tp._sparse_relation_pairs("dedupe", bounds, 0.5, areas=areas)


@pytest.mark.parametrize("n", [1, 8, 13, 64, 77])
def test_pack_bits_rows_is_msb_first(n):
    import torch
    rng = np.random.default_rng(n)
    m = (rng.random((5, n)) < 0.4).astype(np.uint8)
    packed = tp._pack_bits_rows(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(packed, np.packbits(m, axis=1))
    np.testing.assert_array_equal(
        np.unpackbits(packed, axis=1, count=n), m)


def _seeded_crowns(n=320, seed=0):
    """A few hundred crowns at UTM magnitudes over a 200 m raster: irregular
    rings, near-duplicates (dedupe), small crowns inside big ones
    (containment), some over nodata and some off the raster."""
    rng = np.random.default_rng(seed)
    crowns = []
    for _ in range(n):
        k = int(rng.integers(10, 40))
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        rad = rng.uniform(1.5, 9.0) * rng.uniform(0.8, 1.2, k)
        c = rng.uniform(-5, 205, 2)
        ring = np.stack([OX + c[0] + rad * np.cos(ang),
                         OY + c[1] + rad * np.sin(ang)], axis=1)
        crowns.append(np.vstack([ring, ring[:1]]))
    for i in range(40):
        crowns.append(crowns[i] + rng.normal(0, 0.05, (1, 2)))
    for i in range(40, 70):
        centre = crowns[i][:-1].mean(axis=0)
        crowns.append(circle(centre[0], centre[1], 0.9, n=12))
    crowns.append(square(OX + 20, OY + 20, 60))               # an umbrella
    scores = rng.uniform(0.2, 1.0, len(crowns)).astype(np.float32)
    yy, xx = np.mgrid[0:200, 0:200]
    height = (12 + 10 * np.sin(xx / 9.0) * np.cos(yy / 13.0)
              + rng.uniform(0, 1, (200, 200))).astype(np.float32)
    height[50:62, 50:70] = np.nan
    ndvi = (0.35 + 0.3 * np.sin(xx[::5, ::5] / 15.0)
            + rng.uniform(-0.05, 0.05, (40, 40))).astype(np.float32)
    return crowns, scores, height, ndvi


def _assert_same_output(ours, theirs):
    (go, po), (gj, pj) = ours, theirs
    assert len(go) == len(gj)
    for a, b, p, q in zip(go, gj, po, pj):
        np.testing.assert_array_equal(a, b)
        assert list(p) == list(q)
        for key in q:
            if isinstance(q[key], float):
                assert p[key] == pytest.approx(q[key], rel=1e-5, abs=1e-6), key
            else:
                assert p[key] == q[key], key


@pytest.mark.parametrize("device_branch", ["0", "1"])
@pytest.mark.parametrize("rasters", ["both", "height", "ndvi", "none",
                                     "gather"])
def test_process_crowns_matches_jax(monkeypatch, device_branch, rasters):
    """Same kept geometries and properties as the JAX package under both
    TD_PAIRS_DEVICE settings, with both rasters (the fused patch path),
    one of them, none, and the gather path (TD_STATS_PATCH=0)."""
    monkeypatch.setenv("TD_PAIRS_DEVICE", device_branch)
    if rasters == "gather":
        monkeypatch.setenv("TD_STATS_PATCH", "0")
    crowns, scores, height, ndvi = _seeded_crowns()
    use_h = rasters in ("both", "height", "gather")
    use_n = rasters in ("both", "ndvi", "gather")
    rb = (OX, OY, OX + 200, OY + 200)

    def run(mod, affine_cls, cfg):
        return mod.process_crowns(
            crowns, scores, cfg,
            height if use_h else None,
            affine_cls(1.0, 0, OX, 0, -1.0, OY + 200) if use_h else None,
            ndvi if use_n else None,
            affine_cls(5.0, 0, OX, 0, -5.0, OY + 200) if use_n else None, rb)

    cfg = _config(use_overlap=True, overlapping_tiles_width=0.2,
                  overlapping_tiles_height=0.2)
    ours = run(tp, Affine, cfg)
    theirs = run(jp, JaxAffine, {k: v for k, v in cfg.items()
                                 if k != "device"})
    _assert_same_output(ours, theirs)
    assert 30 < len(ours[0]) < len(crowns), "the gates must bite, not empty"
    if rasters == "both":
        assert any(p["is_contained"] for p in ours[1])
        assert any(p["num_contained"] for p in ours[1])
        assert any(p["TreeHeight"] > 3 for p in ours[1])


def test_over_span_polygon_takes_the_numpy_twin(monkeypatch):
    """A crown wider than every patch goes through the host twin in both
    packages (on a raster larger than the largest patch)."""
    big = square(OX + 10, OY + 10, 300)       # 300 px > 256-px patch
    small = circle(OX + 400, OY + 400, 6)
    rng = np.random.default_rng(2)
    height = rng.uniform(5, 20, (512, 512)).astype(np.float32)
    cfg = _config()
    monkeypatch.setattr(tp, "AREA_UPPER_BOUND", 1e9)
    monkeypatch.setattr(jp, "AREA_UPPER_BOUND", 1e9)
    args = (np.array([0.9, 0.8], dtype=np.float32),)
    ours = tp.process_crowns([big, small], *args, cfg, height,
                             Affine(1.0, 0, OX, 0, -1.0, OY + 512), None,
                             None, None)
    theirs = jp.process_crowns([big, small], *args,
                               {k: v for k, v in cfg.items() if k != "device"},
                               height, JaxAffine(1.0, 0, OX, 0, -1.0, OY + 512),
                               None, None, None)
    _assert_same_output(ours, theirs)
    assert len(ours[0]) == 2


CASES = ("confidence_and_area", "utm_magnitude", "height_gate", "ndvi_gate",
         "iou_dedupe", "containment_umbrella", "border_exclusion")


@pytest.mark.parametrize("case", CASES)
def test_postprocessing_cases(case):
    """The decision-rule cases of the JAX package's pipeline tests, run
    against the port."""
    t = Affine.from_origin(0, 100, 1.0, 1.0)
    if case == "confidence_and_area":
        crowns = [square(6, 6, 8), square(26, 26, 8), square(50, 50, 0.5)]
        scores = np.array([0.9, 0.1, 0.9], dtype=np.float32)
        geoms, props = tp.process_crowns(crowns, scores, _config(), None,
                                         None, None, None, None)
        assert len(geoms) == 1
        assert props[0]["Confidence_score"] == pytest.approx(0.9)
        assert props[0]["Area"] == pytest.approx(64.0, rel=1e-3)
        assert props[0]["Diameter"] == pytest.approx(
            2 * np.sqrt(64 / np.pi), rel=1e-3)
    elif case == "utm_magnitude":
        tu = Affine.from_origin(OX, OY + 100, 1.0, 1.0)
        height = np.full((100, 100), 10.0, dtype=np.float32)
        crowns = [square(OX + 6, OY + 6, 8), square(OX + 30, OY + 30, 9)]
        geoms, props = tp.process_crowns(
            crowns, np.array([0.9, 0.8], dtype=np.float32), _config(),
            height, tu, None, None, (OX, OY, OX + 100, OY + 100))
        assert len(geoms) == 2
        assert props[0]["Area"] == pytest.approx(64.0, rel=1e-3)
        assert props[1]["Area"] == pytest.approx(81.0, rel=1e-3)
        assert props[0]["TreeHeight"] == pytest.approx(10.0, abs=0.1)
        assert f"'x': {OX + 10.0}" in props[0]["Centroid"]
    elif case == "height_gate":
        height = np.zeros((100, 100), dtype=np.float32)
        height[10:30, 10:30] = 10.0
        geoms, props = tp.process_crowns(
            [circle(20, 80, 5), circle(70, 20, 5)],
            np.array([0.9, 0.9], dtype=np.float32), _config(), height, t,
            None, None, None)
        assert len(geoms) == 1
        assert props[0]["TreeHeight"] == pytest.approx(10.0, abs=0.5)
    elif case == "ndvi_gate":
        ndvi = np.full((100, 100), 0.02, dtype=np.float32)
        ndvi[60:95, 5:40] = 0.5
        geoms, _ = tp.process_crowns(
            [circle(20, 20, 8), circle(70, 70, 8)],
            np.array([0.9, 0.9], dtype=np.float32), _config(), None, None,
            ndvi, t, None)
        assert len(geoms) == 1
    elif case == "iou_dedupe":
        crowns = [circle(20, 20, 5), circle(20.5, 20, 5), circle(60, 60, 5)]
        _, props = tp.process_crowns(
            crowns, np.array([0.7, 0.95, 0.8], dtype=np.float32),
            _config(iou_threshold=0.5), None, None, None, None, None)
        assert sorted(p["Confidence_score"] for p in props) == \
            pytest.approx([0.8, 0.95])
    elif case == "containment_umbrella":
        crowns = [square(0, 0, 40), circle(8, 8, 3), circle(20, 20, 3),
                  circle(32, 32, 3)]
        geoms, props = tp.process_crowns(
            crowns, np.full(4, 0.9, dtype=np.float32), _config(), None, None,
            None, None, None)
        assert len(geoms) == 3
        assert all(p["Area"] < 100 for p in props)
    else:
        cfg = _config(use_overlap=True)
        bounds = np.array([[0.5, 50, 8, 58], [500, 500, 520, 520],
                           [40, 40, 60, 60]])
        keep = tp.border_overlap_exclusion(bounds, (0, 0, 1000, 1000), cfg,
                                           is_merged_strip=False)
        assert keep.tolist() == [False, True, False]
        assert tp.border_overlap_exclusion(
            np.array([[400, 400, 420, 420]]), (0, 0, 1000, 1000), cfg,
            False).tolist() == [True]


def test_band_sidecar_runs_exclusion_without_rasters(tmp_path):
    """With no raster matched, the exclusion still runs from the bounds the
    Predictor recorded in band_predrop.json."""
    crowns = [square(400, 400, 10), square(30, 400, 10)]
    props = [{"Confidence_score": 0.9}, {"Confidence_score": 0.9}]
    gpkg = tmp_path / "img.gpkg"
    write_gpkg(str(gpkg), crowns, props, srs_id=25832)
    cfg = {"use_overlap": True, "tile_width": 50, "tile_height": 50,
           "buffer": 20, "overlapping_tiles_width": 3,
           "overlapping_tiles_height": 3, "height_threshold": 0,
           "confidence_threshold": 0.3, "device": "cpu"}
    out = tmp_path / "processed_img.gpkg"
    assert tp.process_single_file(str(gpkg), cfg, None, None, str(out)) == 2
    (tmp_path / "img").mkdir()
    (tmp_path / "img" / "band_predrop.json").write_text(
        json.dumps({"bounds": [0.0, 0.0, 1000.0, 1000.0]}))
    assert tp.process_single_file(str(gpkg), cfg, None, None, str(out)) == 1
    geoms, _, _ = read_gpkg(str(out))
    assert np.asarray(geoms[0][0][0])[:, 0].min() >= 135.0


def test_default_device_raises_without_a_card():
    """No fallback: without ``device: cpu`` the crown filter asks for CUDA
    and, on a machine without it, raises."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cfg = _config()
    del cfg["device"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.process_crowns([square(0, 0, 8)], np.array([0.9], np.float32),
                          cfg, None, None, None, None, None)


def test_downscale_matches_jax():
    rng = np.random.default_rng(4)
    arr = rng.uniform(0, 30, (40, 56)).astype(np.float32)
    ours, t_ours = tp._downscale(arr, Affine(0.2, 0, OX, 0, -0.2, OY), 0.25,
                                 device="cpu")
    theirs, t_theirs = jp._downscale(arr, JaxAffine(0.2, 0, OX, 0, -0.2, OY),
                                     0.25)
    assert ours.shape == theirs.shape == (10, 14)
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)
    assert tuple(t_ours) == tuple(t_theirs)
