"""The port's vector stack against the JAX package's: native ring
simplification against the numpy version, GPKG/GeoJSON/shapefile files
exchanged between the two packages, polygon math, the forest flags of the
tiler and the outline mask.  Tolerance: everything identical."""

import struct

import numpy as np
import pytest

from treedetection_tpu import fusion as jax_fusion
from treedetection_tpu import preprocessing as jax_pre
from treedetection_tpu import vector as jv
from treedetection_tpu.geo import Affine as JaxAffine
from treedetection_tpu.vector import polygon as jpoly
from treedetection_tpu.vector.geojson import (
    read_geojson as jax_read_geojson, write_geojson as jax_write_geojson)
from treedetection_tpu_torch import fusion as port_fusion
from treedetection_tpu_torch import native
from treedetection_tpu_torch import preprocessing as port_pre
from treedetection_tpu_torch import vector as pv
from treedetection_tpu_torch.geo import Affine
from treedetection_tpu_torch.vector import polygon as ppoly
from treedetection_tpu_torch.vector.geojson import read_geojson, write_geojson


def square(x0, y0, size):
    return np.array([[x0, y0], [x0 + size, y0], [x0 + size, y0 + size],
                     [x0, y0 + size]], dtype=np.float64)


def _rings(n, seed=0, closed=True):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(3, 120))
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        rad = rng.uniform(0.5, 12.0) * rng.uniform(0.85, 1.15, k)
        c = rng.uniform(412000, 412500, 2) + [0, 4905000]
        ring = np.stack([c[0] + rad * np.cos(ang), c[1] + rad * np.sin(ang)],
                        axis=1)
        # pixel-staircase rings, as the contour tracer makes them
        if rng.random() < 0.5:
            ring = np.round(ring * 5) / 5
        out.append(np.vstack([ring, ring[:1]]) if closed else ring)
    return out


@pytest.mark.parametrize("tolerance", [0.0, 0.2, 2.0, 50.0])
def test_simplify_native_equals_numpy_and_jax(tolerance):
    """The native Douglas-Peucker keeps the same vertices as the port's
    numpy version and as the JAX package's simplify_polygon."""
    for ring in _rings(150, seed=int(tolerance * 10)) + [
            square(0, 0, 4), np.zeros((6, 2)), square(0, 0, 4)[:3]]:
        got = pv.simplify_polygon(ring, tolerance)
        np.testing.assert_array_equal(
            got, ppoly.simplify_polygon_numpy(ring, tolerance))
        np.testing.assert_array_equal(got, jv.simplify_polygon(ring, tolerance))
        assert np.array_equal(got[0], got[-1])          # closed


def test_simplify_keep_flags_raises_nothing_and_keeps_ends():
    ring = _rings(1, seed=9, closed=False)[0]
    flags = native.simplify_keep_flags(ring, 0.5)
    assert flags.dtype == bool and flags.shape == (len(ring),)
    assert flags[0] and 3 <= flags.sum() <= len(ring)


PROPS = [{"Confidence_score": 0.91, "poly_id": 3, "Area": 12.5,
          "Centroid": "{'x': 1.0, 'y': 2.0}", "is_contained": True,
          "num_contained": 0},
         {"Confidence_score": 0.5, "poly_id": 4, "Area": 7.25,
          "Centroid": "{'x': 3.0, 'y': 4.0}", "is_contained": False,
          "num_contained": 2}]


def _assert_layers_equal(a, b):
    (ga, pa, sa), (gb, pb, sb) = a, b
    assert sa == sb and pa == pb and len(ga) == len(gb)
    for x, y in zip(ga, gb):
        assert len(x) == len(y)
        for px, py in zip(x, y):
            assert len(px) == len(py)
            for rx, ry in zip(px, py):
                np.testing.assert_array_equal(np.asarray(rx), np.asarray(ry))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_gpkg_crosses_the_packages(tmp_path, writer):
    """A GPKG written by one package reads identically in both: geometry,
    properties (types kept) and SRS; the empty layer too."""
    geoms = [r for r in _rings(2, seed=4)]
    path = str(tmp_path / "layer.gpkg")
    (pv if writer == "port" else jv).write_gpkg(path, geoms, PROPS,
                                                srs_id=25832)
    ours, theirs = pv.read_gpkg(path), jv.read_gpkg(path)
    _assert_layers_equal(ours, theirs)
    assert ours[2] == 25832 and len(ours[0]) == 2
    for ring, geom in zip(geoms, ours[0]):
        np.testing.assert_array_equal(np.asarray(geom[0][0]), ring)
    assert isinstance(ours[1][0]["poly_id"], int)
    assert ours[1][0]["is_contained"] in (True, 1)
    empty = str(tmp_path / "empty.gpkg")
    (pv if writer == "port" else jv).write_gpkg(empty, [], [])
    _assert_layers_equal(pv.read_gpkg(empty), jv.read_gpkg(empty))


def test_gpkg_bytes_written_are_identical(tmp_path):
    """Same geometry blobs and attribute rows from both writers (the file
    bytes carry a timestamp, so compare the tables)."""
    import sqlite3
    geoms = _rings(3, seed=5)
    props = [{"Confidence_score": 0.1 * i} for i in range(3)]
    rows = []
    for mod, name in ((pv, "p.gpkg"), (jv, "j.gpkg")):
        path = str(tmp_path / name)
        mod.write_gpkg(path, geoms, props, srs_id=25832)
        with sqlite3.connect(path) as db:
            table = db.execute(
                "SELECT table_name FROM gpkg_contents").fetchone()[0]
            rows.append(db.execute(f'SELECT * FROM "{table}"').fetchall())
    assert rows[0] == rows[1] and len(rows[0]) == 3


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_geojson_crosses_the_packages(tmp_path, writer):
    path = str(tmp_path / "f.geojson")
    geoms = [square(0, 0, 4), _rings(1, seed=6)[0]]
    props = [{"score": 0.7}, {"score": 0.2, "name": "a b"}]
    (write_geojson if writer == "port" else jax_write_geojson)(
        path, geoms, props, crs_epsg=25832)
    (go, po), (gj, pj) = read_geojson(path), jax_read_geojson(path)
    assert po == pj == props
    _assert_layers_equal((go, po, 0), (gj, pj, 0))
    assert abs(ppoly.polygon_area(go[0][0][0]) - 16.0) < 1e-9


def _handmade_shapefile(path, rings):
    """One polygon record per ring (CW exterior), no .dbf."""
    records = b""
    for i, ring in enumerate(rings, start=1):
        content = struct.pack("<i", 5)
        content += struct.pack("<4d", *ring.min(0), *ring.max(0))
        content += struct.pack("<ii", 1, len(ring)) + struct.pack("<i", 0)
        content += ring.astype("<f8").tobytes()
        records += struct.pack(">ii", i, len(content) // 2) + content
    header = struct.pack(">i", 9994) + b"\0" * 20
    header += struct.pack(">i", (100 + len(records)) // 2)
    header += struct.pack("<ii", 1000, 5)
    header += struct.pack("<8d", 0, 0, 10, 10, 0, 0, 0, 0)
    path.write_bytes(header + records)


def test_shapefile_and_outline_loader(tmp_path):
    rings = [np.array([[0, 0], [0, 10], [10, 10], [10, 0], [0, 0]], float),
             np.array([[20, 0], [20, 5], [28, 5], [28, 0], [20, 0]], float)]
    shp = tmp_path / "o.shp"
    _handmade_shapefile(shp, rings)
    (go, po), (gj, pj) = pv.read_shapefile(str(shp)), jv.read_shapefile(str(shp))
    assert po == pj and len(go) == 2
    _assert_layers_equal((go, po, 0), (gj, pj, 0))
    gpkg, gjson = str(tmp_path / "o.gpkg"), str(tmp_path / "o.geojson")
    jv.write_gpkg(gpkg, rings, [{}, {}])
    jax_write_geojson(gjson, rings, [{}, {}])
    for path in (str(shp), gpkg, gjson):
        ours = port_pre.load_outline_polygons(path)
        theirs = jax_pre.load_outline_polygons(path)
        assert len(ours) == len(theirs) == 2
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        port_pre.load_outline_polygons(str(tmp_path / "o.txt"))


def test_polygon_math_matches_jax():
    rings = _rings(30, seed=7)
    for a, b in zip(rings[:-1], rings[1:]):
        assert ppoly.polygon_area(a) == jpoly.polygon_area(a)
        assert ppoly.polygon_centroid(a) == jpoly.polygon_centroid(a)
        assert ppoly.polygon_bounds(a) == jpoly.polygon_bounds(a)
        assert ppoly.polygon_intersects(a, b) == jpoly.polygon_intersects(a, b)
        assert ppoly.polygon_iou(a, b + (a.mean(0) - b.mean(0)) * 0.9) == \
            jpoly.polygon_iou(a, b + (a.mean(0) - b.mean(0)) * 0.9)
        box = (a[:, 0].min() + 1, a[:, 1].min() + 1, a[:, 0].max() - 1,
               a[:, 1].max() - 1)
        np.testing.assert_array_equal(ppoly.clip_polygon_box(a, box),
                                      jpoly.clip_polygon_box(a, box))
    ours = ppoly.PolygonSet.from_list(rings, dtype=np.float32)
    theirs = jpoly.PolygonSet.from_list(rings, dtype=np.float32)
    np.testing.assert_array_equal(ours.coords, theirs.coords)
    t, jt = Affine(0.5, 0, 412000, 0, -0.5, 5317600), \
        JaxAffine(0.5, 0, 412000, 0, -0.5, 5317600)
    local = [r - [0, 4905000 - 5317000] for r in rings]
    np.testing.assert_array_equal(
        pv.rasterize_polygons(local, t, (1200, 1100), dtype=np.uint8),
        jv.rasterize_polygons(local, jt, (1200, 1100), dtype=np.uint8))


def test_forest_flags_match_jax(tmp_raster, tmp_path):
    """The tiler's forest/urban flags: the arrays and the written metadata
    are identical with a forest outline over part of the raster."""
    forest = [np.array([[411990., 5317890.], [412060., 5317890.],
                        [412060., 5318010.], [411990., 5318010.]]),
              square(412085, 5317905, 3)]
    xs, ys = port_pre.tile_grid((412000, 5317900, 412100, 5318000), 25, 25)
    for buffer in (0, 5):
        ours = port_pre.compute_forest_flags(xs, ys, 25, 25, buffer, forest)
        theirs = jax_pre.compute_forest_flags(xs, ys, 25, 25, buffer, forest)
        np.testing.assert_array_equal(ours[0], theirs[0])
        np.testing.assert_array_equal(ours[1], theirs[1])
    assert ours[0].any() and ours[1].any() and not (ours[0] & ours[1]).any()
    a = port_pre.tile_single_file(tmp_raster["rgb"], str(tmp_path / "p"),
                                  buffer=5, tile_width=25, tile_height=25,
                                  forest_polys=forest)
    b = jax_pre.tile_single_file(tmp_raster["rgb"], str(tmp_path / "j"),
                                 buffer=5, tile_width=25, tile_height=25,
                                 forest_polys=forest)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_outline_mask_and_exclude_outlines_match_jax(tmp_path):
    outlines = [square(0, 0, 20), square(26, 0, 34)]
    ours = port_fusion.OutlineMask(outlines, (0, 0, 60, 40), resolution=0.5)
    theirs = jax_fusion.OutlineMask(outlines, (0, 0, 60, 40), resolution=0.5)
    np.testing.assert_array_equal(ours.mask, theirs.mask)
    spanning = np.array([[5., 5.], [55., 5.], [55., 35.], [5., 35.], [5., 5.]])
    for crown in (spanning, square(4, 4, 12), square(100, 100, 5),
                  square(21, 1, 0.2)):
        assert ours.polygon_relation(crown) == theirs.polygon_relation(crown)
    assert ours.polygon_relation(spanning) == (True, False)
    water = str(tmp_path / "water.geojson")
    write_geojson(water, [square(0, 0, 50)], [{}])
    crowns = [np.vstack([square(20, 20, 8), [[20, 20]]]),
              np.vstack([square(100, 100, 8), [[100, 100]]])]
    paths = []
    for mod, vec, name in ((port_fusion, pv, "p.gpkg"),
                           (jax_fusion, jv, "j.gpkg")):
        path = str(tmp_path / name)
        vec.write_gpkg(path, crowns, [{"Confidence_score": 0.9},
                                      {"Confidence_score": 0.8}])
        mod.exclude_outlines([path], [water])
        paths.append(path)
    _assert_layers_equal(pv.read_gpkg(paths[0]), jv.read_gpkg(paths[1]))
    assert len(pv.read_gpkg(paths[0])[0]) == 1
    # fuse_predictions runs (tests/test_torch_fusion.py holds it against the
    # JAX package): with no stitched layer it fuses nothing, as JAX's does
    for mod, name in ((port_fusion, "fused_p"), (jax_fusion, "fused_j")):
        assert mod.fuse_predictions({}, [], [], water,
                                    str(tmp_path / name)) == []
