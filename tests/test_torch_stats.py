"""``ops/stats.py`` of the port against the JAX package's, on the CPU in
float32, from the same numpy inputs.

Two kinds of input.  **Lattice inputs** make every intermediate exactly
representable (vertices on a 1/8 lattice, bbox spans of 8 or 16, raster
values multiples of 1/4, pixel sizes 1 and 2): then XLA's fused multiply-adds
and eager PyTorch's separately rounded operations give the same bits, and the
tolerances are: ``count`` and ``argmax_xy`` identical, max/min/mean exact, var
within 1e-4 relative + 1e-6 (it squares inexact differences, summed in
another order).  **Generic inputs** (arbitrary floats) show what remains when
the last bit of a sample coordinate differs between the two (``min + t *
span`` is one FMA under XLA): a sample on a polygon edge may flip (count
within 2 on at most 2% of the polygons) and, on the others, the interpolated
values move by the raster's gradient times that rounding: max/min/mean within
1e-5 relative + 1e-4, var within 1e-4 relative + 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treedetection_tpu.ops import stats as js
from treedetection_tpu_torch.ops import stats as ts


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _rings(rng, n, p, extent, full_ring_at=None, lattice=True):
    """(n, p, 2) float32 NaN-padded star-shaped rings scattered over
    [-10, extent + 10]^2 (some off the raster), >= 1 NaN pad slot unless
    ``full_ring_at`` names a ring that fills all p slots.  ``lattice``: the
    vertices lie on a 1/8 lattice and the bbox spans are exactly 2 * radius
    with radius 4 or 8."""
    out = np.full((n, p, 2), np.nan, dtype=np.float32)
    for i in range(n):
        k = p if i == full_ring_at else int(rng.integers(8, p))
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        c = rng.uniform(-10, extent + 10, 2)
        if lattice:
            radius = float(rng.choice([4.0, 8.0]))
            ang[:4] = [0.0, np.pi / 2, np.pi, 3 * np.pi / 2]   # the extremes
            ang = np.sort(ang)
            rad = radius * rng.uniform(0.6, 1.0, k)
            rad[np.isin(ang, [0.0, np.pi / 2, np.pi, 3 * np.pi / 2])] = radius
            c = np.round(c * 8) / 8
            xy = np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=1)
            xy = np.round(xy * 8) / 8
        else:
            rad = rng.uniform(1.0, 9.0) * rng.uniform(0.7, 1.3, k)
            xy = np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=1)
        out[i, :k] = c + xy
    return out


def _raster(rng, h, w, lattice=True):
    yy, xx = np.mgrid[0:h, 0:w]
    r = 15 + 10 * np.sin(xx / 7.0) * np.cos(yy / 5.0) \
        + rng.uniform(0, 0.5, (h, w))
    if lattice:
        r = np.round(r * 4) / 4
    r = r.astype(np.float32)
    r[h // 4:h // 4 + 6, w // 3:w // 3 + 9] = np.nan       # nodata cells
    return r


def _affine(h, res):
    return np.array([res, 0.0, 0.0, 0.0, -res, h * res], dtype=np.float32)


def _assert_stats_equal(ours, theirs):
    """The lattice tolerances."""
    count = np.asarray(theirs.count)
    np.testing.assert_array_equal(ours.count.numpy(), count)
    np.testing.assert_array_equal(ours.argmax_xy.numpy(),
                                  np.asarray(theirs.argmax_xy))
    np.testing.assert_array_equal(ours.max.numpy(), np.asarray(theirs.max))
    np.testing.assert_array_equal(ours.min.numpy(), np.asarray(theirs.min))
    np.testing.assert_array_equal(ours.mean.numpy(), np.asarray(theirs.mean))
    np.testing.assert_allclose(ours.var.numpy(), np.asarray(theirs.var),
                               rtol=1e-4, atol=1e-6)
    assert (count > 0).any() and (count == 0).any(), \
        "want polygons on AND off the raster"
    empty = count == 0
    for field in (ours.max, ours.min, ours.mean, ours.var):
        assert (field.numpy()[empty] == -1.0).all()      # empty sentinels


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    polys = _rings(rng, 300, 24, 100.0, full_ring_at=5)  # > one 256 chunk
    return {"polys": polys,
            "a": _raster(rng, 100, 100), "aff_a": _affine(100, 1.0),
            "b": _raster(rng, 50, 50), "aff_b": _affine(50, 2.0)}


@pytest.mark.parametrize("compat_circle", [False, True])
def test_gather_one_raster(data, compat_circle):
    ours = ts.polygon_raster_stats_batch(
        _t(data["polys"]), _t(data["a"]), _t(data["aff_a"]), grid=16,
        compat_circle=compat_circle)
    theirs = js.polygon_raster_stats_batch(
        jnp.asarray(data["polys"]), jnp.asarray(data["a"]),
        jnp.asarray(data["aff_a"]), grid=16, compat_circle=compat_circle)
    _assert_stats_equal(ours, theirs)


def test_gather_two_rasters(data):
    ours = ts.polygon_raster_stats_two(
        _t(data["polys"]), _t(data["a"]), _t(data["aff_a"]), _t(data["b"]),
        _t(data["aff_b"]), grid=16)
    theirs = js.polygon_raster_stats_two(
        jnp.asarray(data["polys"]), jnp.asarray(data["a"]),
        jnp.asarray(data["aff_a"]), jnp.asarray(data["b"]),
        jnp.asarray(data["aff_b"]), grid=16)
    for o, t in zip(ours, theirs):
        _assert_stats_equal(o, t)


@pytest.mark.parametrize("compat_circle", [False, True])
def test_patch_one_raster(data, compat_circle):
    ours = ts.polygon_raster_stats_batch_patch(
        _t(data["polys"]), _t(data["a"]), _t(data["aff_a"]), grid=16,
        patch=32, compat_circle=compat_circle)
    theirs = js.polygon_raster_stats_batch_patch(
        jnp.asarray(data["polys"]), jnp.asarray(data["a"]),
        jnp.asarray(data["aff_a"]), grid=16, patch=32,
        compat_circle=compat_circle)
    _assert_stats_equal(ours, theirs)


def test_patch_two_rasters(data):
    ours = ts.polygon_raster_stats_two_patch(
        _t(data["polys"]), _t(data["a"]), _t(data["aff_a"]), _t(data["b"]),
        _t(data["aff_b"]), grid=16, patch_a=32, patch_b=16)
    theirs = js.polygon_raster_stats_two_patch(
        jnp.asarray(data["polys"]), jnp.asarray(data["a"]),
        jnp.asarray(data["aff_a"]), jnp.asarray(data["b"]),
        jnp.asarray(data["aff_b"]), grid=16, patch_a=32, patch_b=16)
    for o, t in zip(ours, theirs):
        _assert_stats_equal(o, t)


def test_generic_floats_within_stated_tolerance():
    """Arbitrary float inputs through the gather and the patch path."""
    rng = np.random.default_rng(5)
    polys = _rings(rng, 300, 24, 100.0, lattice=False)
    raster, aff = _raster(rng, 100, 100, lattice=False), _affine(100, 1.0)
    pairs = [
        (ts.polygon_raster_stats_batch(_t(polys), _t(raster), _t(aff),
                                       grid=16),
         js.polygon_raster_stats_batch(jnp.asarray(polys),
                                       jnp.asarray(raster), jnp.asarray(aff),
                                       grid=16)),
        (ts.polygon_raster_stats_batch_patch(_t(polys), _t(raster), _t(aff),
                                             grid=16, patch=32),
         js.polygon_raster_stats_batch_patch(jnp.asarray(polys),
                                             jnp.asarray(raster),
                                             jnp.asarray(aff), grid=16,
                                             patch=32))]
    for ours, theirs in pairs:
        d = np.abs(ours.count.numpy() - np.asarray(theirs.count))
        assert d.max() <= 2 and (d > 0).mean() <= 0.02
        same = d == 0
        assert (np.asarray(theirs.count)[same] > 0).sum() > 100
        for name, rtol in (("max", 1e-5), ("min", 1e-5), ("mean", 1e-5),
                           ("var", 1e-4)):
            np.testing.assert_allclose(
                getattr(ours, name).numpy()[same],
                np.asarray(getattr(theirs, name))[same], rtol=rtol, atol=1e-4)
        np.testing.assert_allclose(ours.argmax_xy.numpy()[same],
                                   np.asarray(theirs.argmax_xy)[same],
                                   rtol=0, atol=1e-4)


def test_patch_path_equals_gather_path():
    """Where every polygon's pixel span fits the window, the patch path
    gives the gather path's samples: same counts and argmax, NaN nodata
    cells marked on the same samples.  (Generic floats: on the lattice a
    sample exactly on a pixel centre has a zero-weight tap, which the gather
    path turns into NaN when that tap is nodata and the patch path, by
    design, does not -- in both packages.)"""
    rng = np.random.default_rng(5)
    polys = _t(_rings(rng, 300, 24, 100.0, lattice=False))
    raster = _t(_raster(rng, 100, 100, lattice=False))
    aff = _t(_affine(100, 1.0))
    g = ts.polygon_raster_stats_batch(polys, raster, aff, grid=16)
    p = ts.polygon_raster_stats_batch_patch(polys, raster, aff, grid=16,
                                            patch=32)
    np.testing.assert_array_equal(g.count.numpy(), p.count.numpy())
    np.testing.assert_array_equal(g.argmax_xy.numpy(), p.argmax_xy.numpy())
    np.testing.assert_allclose(g.max.numpy(), p.max.numpy(), rtol=1e-5,
                               atol=1e-4)


def test_points_in_polygons_and_grid(data):
    polys = data["polys"][:40]
    pts_t, cell_t = ts.sample_grid_over_bboxes(_t(polys), 8)
    pts_j, cell_j = js.sample_grid_over_bboxes(jnp.asarray(polys), 8)
    np.testing.assert_array_equal(pts_t.numpy(), np.asarray(pts_j))
    np.testing.assert_array_equal(cell_t.numpy(), np.asarray(cell_j))
    closed_t = ts._close_rings(_t(polys))
    closed_j = js._close_rings(jnp.asarray(polys))
    np.testing.assert_array_equal(closed_t.numpy(), np.asarray(closed_j))
    # ring 5 has no pad slot: it must stay as it was
    np.testing.assert_array_equal(closed_t.numpy()[5], polys[5])
    inside_t = ts.points_in_polygons(pts_t, closed_t)
    inside_j = js.points_in_polygons(pts_j, closed_j)
    np.testing.assert_array_equal(inside_t.numpy(), np.asarray(inside_j))
    assert 0 < inside_t.sum() < inside_t.numel()


def test_bilinear_sample_raster(data):
    rng = np.random.default_rng(3)
    pts = rng.uniform(-5, 105, (7, 50, 2)).astype(np.float32)
    ours = ts.bilinear_sample_raster(_t(data["a"]), _t(data["aff_a"]),
                                     _t(pts)).numpy()
    theirs = np.asarray(js.bilinear_sample_raster(
        jnp.asarray(data["a"]), jnp.asarray(data["aff_a"]),
        jnp.asarray(pts)))
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(theirs))
    assert np.isnan(ours).any() and not np.isnan(ours).all()
    np.testing.assert_allclose(np.nan_to_num(ours), np.nan_to_num(theirs),
                               rtol=1e-6, atol=1e-6)


def test_areas_and_centroids(data):
    polys = data["polys"]
    np.testing.assert_allclose(
        ts.polygon_areas_batch(_t(polys)).numpy(),
        np.asarray(js.polygon_areas_batch(jnp.asarray(polys))),
        rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        ts.polygon_centroids_batch(_t(polys)).numpy(),
        np.asarray(js.polygon_centroids_batch(jnp.asarray(polys))),
        rtol=1e-6, atol=1e-5)


def test_argmax_is_the_first_maximum():
    """A flat raster: every inside sample ties, and the first one wins (as
    jnp.argmax returns it)."""
    ring = np.full((1, 6, 2), np.nan, dtype=np.float32)
    ring[0, :4] = [[2, 2], [8, 2], [8, 8], [2, 8]]
    raster = np.full((10, 10), 7.0, dtype=np.float32)
    aff = _affine(10, 1.0)
    ours = ts.polygon_raster_stats_batch(_t(ring), _t(raster), _t(aff), grid=4)
    theirs = js.polygon_raster_stats_batch(
        jnp.asarray(ring), jnp.asarray(raster), jnp.asarray(aff), grid=4)
    np.testing.assert_array_equal(ours.argmax_xy.numpy(),
                                  np.asarray(theirs.argmax_xy))
    pts, _ = ts.sample_grid_over_bboxes(_t(ring), 4)
    np.testing.assert_array_equal(ours.argmax_xy.numpy()[0], pts[0, 0].numpy())


def test_chunking_does_not_change_results(data, monkeypatch):
    whole = ts.polygon_raster_stats_batch_patch(
        _t(data["polys"]), _t(data["a"]), _t(data["aff_a"]), grid=8, patch=32)
    monkeypatch.setattr(ts, "CHUNK", 64)
    parts = ts.polygon_raster_stats_batch_patch(
        _t(data["polys"]), _t(data["a"]), _t(data["aff_a"]), grid=8, patch=32)
    for a, b in zip(whole, parts):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_devices_must_agree_and_empty_input(data):
    empty = ts.polygon_raster_stats_batch(
        torch.zeros((0, 8, 2)), _t(data["a"]), _t(data["aff_a"]), grid=4)
    assert empty.max.shape == (0,) and empty.argmax_xy.shape == (0, 2)
    with pytest.raises(ValueError):
        ts.polygon_raster_stats_batch(
            _t(data["polys"]), _t(data["a"]).to("meta"), _t(data["aff_a"]))
