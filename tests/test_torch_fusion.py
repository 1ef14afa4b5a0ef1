"""``fusion.fuse_predictions`` of the port against the JAX package's, on
seeded circles and a forest outline.  Both sides are numpy and write through
their own GPKG writers: the fused layers must hold the same rings with the
same properties in the same order (exact equality)."""

import os
from pathlib import Path

import numpy as np
import pytest

from treedetection_tpu import fusion as jax_fusion
from treedetection_tpu_torch import fusion
from treedetection_tpu_torch.recoveries import load_fusion_recovery_data
from treedetection_tpu_torch.vector import read_gpkg, write_gpkg
from treedetection_tpu_torch.vector.geojson import write_geojson


def circle(cx, cy, r, n=24):
    a = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([cx + r * np.cos(a), cy + r * np.sin(a)], axis=1)


def square(x0, y0, s):
    return np.array([[x0, y0], [x0 + s, y0], [x0 + s, y0 + s], [x0, y0 + s]],
                    dtype=np.float64)


def _layers(root: Path, seed: int, stems=("img", "other")):
    """Urban and forest layers of seeded circles scattered over a 300 m
    square whose west part (x < 100, plus an island) is forest."""
    rng = np.random.default_rng(seed)
    outline = str(root / "forest.geojson")
    write_geojson(outline, [square(0, 0, 100) * [1, 3], square(180, 180, 30)],
                  [{}, {}], crs_epsg=25832)
    urban, forest = [], []
    for stem in stems:
        for kind, paths in (("urban", urban), ("forest", forest)):
            rings = [circle(rng.uniform(0, 300), rng.uniform(0, 300),
                            rng.uniform(2, 8)) for _ in range(60)]
            # crowns that straddle the outline edge
            rings += [circle(100 + rng.uniform(-3, 3), rng.uniform(10, 290),
                             5.0) for _ in range(10)]
            path = str(root / f"{stem}_{kind}.gpkg")
            write_gpkg(path, rings, [{"Confidence_score": float(s)}
                                     for s in rng.uniform(0.3, 1, len(rings))],
                       srs_id=25832)
            paths.append(path)
    return urban, forest, outline


def _layer(path):
    geoms, props, srs = read_gpkg(path)
    return [np.asarray(g[0][0]) for g in geoms], props, srs


@pytest.mark.parametrize("seed", [0, 1])
def test_fuse_predictions_equals_jax(tmp_path, seed):
    urban, forest, outline = _layers(tmp_path, seed)
    ours = fusion.fuse_predictions({"logger": None}, urban, forest, outline,
                                   str(tmp_path / "ours"))
    theirs = jax_fusion.fuse_predictions({"logger": None}, urban, forest,
                                         outline, str(tmp_path / "theirs"))
    assert [Path(p).name for p in ours] == [Path(p).name for p in theirs] == \
        ["img.gpkg", "other.gpkg"]
    for a, b in zip(ours, theirs):
        ra, pa, sa = _layer(a)
        rb, pb, sb = _layer(b)
        assert sa == sb == 25832 and pa == pb and len(ra) == len(rb)
        for x, y in zip(ra, rb):
            np.testing.assert_array_equal(x, y)
        # both sides of the outline contribute, and crowns were dropped
        xs = np.array([r[:, 0].mean() for r in ra])
        assert (xs < 90).any() and (xs > 110).any() and 20 < len(ra) < 140
    assert set(load_fusion_recovery_data(str(tmp_path / "ours"))) == \
        {"img", "other"}


def test_fuse_selects_by_outline(tmp_path):
    """The JAX package's own case (``tests/test_pipeline.py``): the forest
    crown inside the outline and the urban crown outside it survive."""
    outline = str(tmp_path / "forest.geojson")
    write_geojson(outline, [square(0, 0, 100)], [{}], crs_epsg=25832)
    urban, forest = str(tmp_path / "img_urban.gpkg"), \
        str(tmp_path / "img_forest.gpkg")
    write_gpkg(forest, [circle(50, 50, 5), circle(500, 500, 5)],
               [{"Confidence_score": 0.9}, {"Confidence_score": 0.8}])
    write_gpkg(urban, [circle(50, 50, 4), circle(200, 200, 4)],
               [{"Confidence_score": 0.7}, {"Confidence_score": 0.6}])
    outs = fusion.fuse_predictions({"logger": None}, [urban], [forest],
                                   outline, str(tmp_path / "fused"))
    _, props, _ = read_gpkg(outs[0])
    assert sorted(round(p["Confidence_score"], 1) for p in props) == [0.6, 0.9]


def test_fuse_empty_and_missing_inputs(tmp_path):
    """An image whose two layers are empty, and one whose forest layer does
    not exist, fuse to the same files as in the JAX package."""
    outline = str(tmp_path / "forest.geojson")
    write_geojson(outline, [square(0, 0, 100)], [{}], crs_epsg=25832)
    empty_u, empty_f = str(tmp_path / "empty_urban.gpkg"), \
        str(tmp_path / "empty_forest.gpkg")
    write_gpkg(empty_u, [], [], srs_id=25832)
    write_gpkg(empty_f, [], [], srs_id=25832)
    lone_u = str(tmp_path / "lone_urban.gpkg")
    write_gpkg(lone_u, [circle(50, 50, 4), circle(200, 200, 4)],
               [{"Confidence_score": 0.7}, {"Confidence_score": 0.6}],
               srs_id=25832)
    args = ([empty_u, lone_u, str(tmp_path / "absent_urban.gpkg")],
            [empty_f, str(tmp_path / "lone_forest.gpkg")], outline)
    ours = fusion.fuse_predictions({"logger": None}, *args,
                                   str(tmp_path / "ours"))
    theirs = jax_fusion.fuse_predictions({"logger": None}, *args,
                                         str(tmp_path / "theirs"))
    assert [Path(p).name for p in ours] == ["empty.gpkg", "lone.gpkg",
                                            "absent.gpkg"]
    counts = []
    for a, b in zip(ours, theirs):
        ra, pa, sa = _layer(a)
        rb, pb, sb = _layer(b)
        assert (pa, sa) == (pb, sb) and len(ra) == len(rb)
        counts.append(len(ra))
    assert counts == [0, 1, 0]


def test_fuse_resumed_call_rewrites_nothing(tmp_path):
    """With the fusion manifest present a second call returns the same
    paths and leaves the files alone; a file deleted since is fused again."""
    urban, forest, outline = _layers(tmp_path, 3)
    out_dir = str(tmp_path / "fused")
    first = fusion.fuse_predictions({"logger": None}, urban, forest, outline,
                                    out_dir)
    stamps = {p: os.stat(p).st_mtime_ns for p in first}
    # resumed: the inputs are not even read
    os.remove(urban[0])
    again = fusion.fuse_predictions({"logger": None}, urban, forest, outline,
                                    out_dir)
    assert again == first
    assert {p: os.stat(p).st_mtime_ns for p in again} == stamps
    os.remove(first[1])
    third = fusion.fuse_predictions({"logger": None}, urban, forest, outline,
                                    out_dir)
    assert third == first and os.path.exists(first[1])
    assert os.stat(first[0]).st_mtime_ns == stamps[first[0]]
