"""The port's evaluation (``eval/``) against the JAX package's, on the CPU:
greedy IoU matching, P/R/F1 at one point, over the threshold grid and over
a confidence sweep, GPKG pairs (the tracked consensus labels among them),
the postprocessing hyperparameter sweep, and the plots.  Matches and
metrics must be EQUAL: both run the same float64 host geometry, and the
tie order of the candidate sort decides matches."""

import json

import numpy as np
import pytest

from treedetection_tpu import eval as jeval
from treedetection_tpu.eval import hyperparams as jhyper
from treedetection_tpu.eval import plots as jplots
from treedetection_tpu.eval import scores as jscores
from treedetection_tpu.eval import validation as jvalid
from treedetection_tpu_torch import eval as teval
from treedetection_tpu_torch.eval import hyperparams as thyper
from treedetection_tpu_torch.eval import plots as tplots
from treedetection_tpu_torch.eval import scores as tscores
from treedetection_tpu_torch.eval import validation as tvalid
from treedetection_tpu_torch.geo import Affine, write_geotiff
from treedetection_tpu_torch.vector import read_gpkg, write_gpkg

from test_torch_postprocessing import OX, OY, _config, _seeded_crowns

REPO_DATA = __import__("pathlib").Path(__file__).resolve().parents[1] / \
    "example" / "data"


def _ring(rng, c, rad, k=None):
    k = k or int(rng.integers(8, 30))
    ang = np.sort(rng.uniform(0, 2 * np.pi, k))
    r = rad * rng.uniform(0.8, 1.2, k)
    return np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1)


def _pred_gt(seed, n_gt=40, n_fp=10):
    """Ground-truth crowns and predictions: each crown jittered (some far
    enough to miss), a few exact copies and duplicates (ties), and false
    positives; seeded scores with ties."""
    rng = np.random.default_rng(seed)
    gts = [_ring(rng, rng.uniform(0, 150, 2), rng.uniform(1.5, 6))
           for _ in range(n_gt)]
    preds = []
    for i, g in enumerate(gts):
        if i % 7 == 0:
            continue                                    # a missed crown
        shift = rng.normal(0, 0.3 if i % 5 else 2.0, 2)
        preds.append(g * rng.uniform(0.9, 1.1) + shift
                     - g.mean(0) * (rng.uniform(0.9, 1.1) - 1))
        if i % 11 == 0:
            preds.append(g.copy())                      # exact duplicate
    preds += [_ring(rng, rng.uniform(0, 150, 2), rng.uniform(1, 4))
              for _ in range(n_fp)]
    scores = rng.uniform(0.05, 1.0, len(preds)).round(2).tolist()
    return preds, scores, gts


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("iou", [0.3, 0.5, 0.8])
def test_greedy_iou_match_equals_jax(seed, iou):
    preds, _, gts = _pred_gt(seed)
    for exact in (True, False):
        got = tscores.greedy_iou_match(preds, gts, iou, exact=exact)
        want = jscores.greedy_iou_match(preds, gts, iou, exact=exact)
        assert got == want
    assert 0 < len(got[0]) < len(gts)
    assert tscores.greedy_iou_match([], gts, iou) == \
        jscores.greedy_iou_match([], gts, iou)
    assert tscores.greedy_iou_match(preds, [], iou) == \
        jscores.greedy_iou_match(preds, [], iou)


@pytest.mark.parametrize("seed", [3, 4])
def test_evaluate_grid_and_sweep_equal_jax(seed, tmp_path):
    preds, scores, gts = _pred_gt(seed, n_gt=30, n_fp=8)
    assert tscores.evaluate(preds, scores, gts, 0.5, 0.4) == \
        jscores.evaluate(preds, scores, gts, 0.5, 0.4)
    ious, confs = (0.3, 0.6, 0.9), (0.2, 0.5, 0.8)
    got = tscores.evaluate_grid(preds, scores, gts, ious, confs,
                                out_json=str(tmp_path / "port.json"))
    want = jscores.evaluate_grid(preds, scores, gts, ious, confs,
                                 out_json=str(tmp_path / "jax.json"))
    assert got == want and len(got) == 9
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
    assert teval.confidence_sweep(preds, scores, gts, 0.4, [0.1, 0.6]) == \
        jeval.confidence_sweep(preds, scores, gts, 0.4, [0.1, 0.6])
    few = _pred_gt(seed, n_gt=8, n_fp=3)               # the default sweep
    assert teval.confidence_sweep(*few, 0.5) == jeval.confidence_sweep(
        *few, 0.5)


def test_filter_annotations_and_boxes_equal_jax():
    rng = np.random.default_rng(5)
    geoms = [_ring(rng, rng.uniform(0, 50, 2), 2.0) for _ in range(6)]
    props = [{"Area": 9.0, "TreeHeight": 10, "MeanNDVI": 0.5}, {"Area": 1.0},
             {"TreeHeight": 3.0}, {"MeanNDVI": 0.15}, {}, {"Area": 1.5}]
    got = teval.filter_annotations(geoms, props)
    want = jeval.filter_annotations(geoms, props)
    assert got[1] == want[1] == [props[0], props[4], props[5]]
    assert all(a is b for a, b in zip(got[0], want[0]))
    np.testing.assert_array_equal(tscores.annotation_boxes(geoms),
                                  jscores.annotation_boxes(geoms))


def test_consensus_gpkg_against_its_jitter_equals_jax(tmp_path):
    """The tracked ``autolabels_consensus.gpkg`` (960 crowns) scored against
    a seeded jitter of itself through ``evaluate_gpkg_pair``, once per
    package: the same metrics, exactly."""
    gt = str(REPO_DATA / "autolabels_consensus.gpkg")
    geoms, _, srs = read_gpkg(gt)
    rng = np.random.default_rng(6)
    rings, props = [], []
    for g in geoms:
        ring = np.asarray(g[0][0], dtype=np.float64)
        c = ring.mean(0)
        ring = (ring - c) * rng.uniform(0.85, 1.15) + c + rng.normal(0, 0.4, 2)
        rings.append(ring)
        props.append({"Confidence_score": float(rng.uniform(0.2, 1.0))})
    pred = str(tmp_path / "jitter.gpkg")
    write_gpkg(pred, rings, props, srs_id=srs)
    got = tvalid.evaluate_gpkg_pair(pred, gt, 0.5, 0.3)
    want = jvalid.evaluate_gpkg_pair(pred, gt, 0.5, 0.3)
    assert got == want
    assert 0 < got["fp"] and 0 < got["fn"] and got["tp"] > 300


def _write_site(tmp_path):
    """The crown filter's seeded crowns as a stitched layer with their
    rasters (nDSM at 1 m, RGBI at 1 m), and annotations: a jittered subset
    of the crowns."""
    crowns, scores, height, _ = _seeded_crowns(n=150, seed=7)
    t = Affine(1.0, 0, OX, 0, -1.0, OY + 200)
    hpath, rpath = tmp_path / "ndsm.tif", tmp_path / "rgbi.tif"
    write_geotiff(str(hpath), np.nan_to_num(height, nan=-9999.0), t,
                  crs=25832, nodata=-9999.0)
    rng = np.random.default_rng(8)
    rgbi = rng.integers(0, 120, (200, 200, 4), dtype=np.uint8)
    rgbi[..., 3] = rng.integers(100, 255, (200, 200))
    write_geotiff(str(rpath), rgbi, t, crs=25832)
    stitched = tmp_path / "stitched.gpkg"
    write_gpkg(str(stitched), crowns,
               [{"Confidence_score": float(s)} for s in scores], srs_id=25832)
    ann = tmp_path / "ann.gpkg"
    write_gpkg(str(ann), [c + rng.normal(0, 0.2, 2) for c in crowns[:150:2]],
               [{} for _ in crowns[:150:2]], srs_id=25832)
    return str(stitched), str(ann), str(hpath), str(rpath)


def test_sweep_postprocessing_rows_equal_jax(tmp_path):
    """A 2 x 2 grid over the crown filter: the same rows in the same
    (F1-sorted) order; the port's filter runs on the config's device."""
    stitched, ann, hpath, rpath = _write_site(tmp_path)
    grid = {"confidence_threshold": (0.3, 0.6), "iou_threshold": (0.4, 0.6)}
    cfg = _config(ndvi_mean_threshold=0.0, ndvi_var_threshold=1.0)
    got = thyper.sweep_postprocessing(stitched, ann, cfg, hpath, rpath, grid,
                                      out_json=str(tmp_path / "port.json"))
    want = jhyper.sweep_postprocessing(
        stitched, ann, {k: v for k, v in cfg.items() if k != "device"},
        hpath, rpath, grid, out_json=str(tmp_path / "jax.json"))
    assert got == want and len(got) == 4
    assert len({r["n_crowns"] for r in got}) > 1 and got[0]["tp"] > 0
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert thyper.DEFAULT_GRID == jhyper.DEFAULT_GRID


def test_plots_equal_jax(tmp_path):
    """The overlay, the sweep plot and the model-comparison plots: the same
    PNG bytes as the JAX package's (matplotlib, imported inside)."""
    pytest.importorskip("matplotlib")
    preds, scores, gts = _pred_gt(9, n_gt=10, n_fp=3)
    for name, sc, ev, vl, pl in (("port", tscores, teval, tvalid, tplots),
                                 ("jax", jscores, jeval, jvalid, jplots)):
        d = tmp_path / name
        d.mkdir()
        sc.visualize_results(preds, scores, gts, str(d / "overlay.png"))
        vl.confidence_sweep(preds, scores, gts,
                            plot_path=str(d / "sweep.png"))
        files = {}
        for model, conf in (("a", (0.3, 0.6)), ("b", (0.4, 0.7))):
            files[model] = str(d / f"{model}.json")
            ev.evaluate_grid(preds, scores, gts, (0.5,), conf,
                             out_json=files[model])
        pl.plot_results(files, str(d / "models.png"), title="t")
        assert pl.plot_site_categories({"City": files}, str(d / "sites")) \
            == [str(d / "sites" / "f1_City.png")]
    for png in ("overlay.png", "sweep.png", "models.png", "sites/f1_City.png"):
        got = (tmp_path / "port" / png).read_bytes()
        assert len(got) > 1000 and got == (tmp_path / "jax" / png).read_bytes()
