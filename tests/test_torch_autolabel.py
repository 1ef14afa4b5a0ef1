"""The port's autolabelling (``autolabel/``) against the JAX package's, on
the CPU: the blur and the crown seeds, Voronoi and region-grow labels from
an nDSM, box-prompted crown cleaning, and the Cambridge flow over a
directory.  The seeds must be EQUAL (the seed index is the Voronoi owner
id) and the smoothed height within 1e-6 of its peak; label rings within
1e-9 m and properties within 1e-5.  The JAX side traces contours with its
native library (``jax_native``)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from treedetection_tpu.autolabel import boxes as jboxes  # noqa: E402
from treedetection_tpu.autolabel import cambridge as jcam  # noqa: E402
from treedetection_tpu.autolabel import sam as jsam  # noqa: E402
from treedetection_tpu.autolabel import voronoi as jvor  # noqa: E402
from treedetection_tpu_torch.autolabel import boxes as tboxes  # noqa: E402
from treedetection_tpu_torch.autolabel import cambridge as tcam  # noqa: E402
from treedetection_tpu_torch.autolabel import sam as tsam  # noqa: E402
from treedetection_tpu_torch.autolabel import voronoi as tvor  # noqa: E402
from treedetection_tpu_torch.geo import Affine, write_geotiff  # noqa: E402
from treedetection_tpu_torch.vector import read_gpkg, write_gpkg  # noqa: E402

from test_torch_jax_native import jax_native  # noqa: E402,F401 (fixture)

ORIGIN = (412000.0, 5318000.0)


def synthetic_ndsm(seed, n=256):
    """Gaussian crowns of 2-12 m radius and 5-30 m height on flat ground
    (some cut by the raster edge), a flat roof plateau at 7.5 m, a plateau
    on the raster's corner, and sparse noise."""
    rng = np.random.default_rng(seed)
    h = np.zeros((n, n), np.float32)
    yy, xx = np.mgrid[0:n, 0:n]
    for _ in range(30):
        cy, cx = rng.uniform(-10, n + 10, 2)
        r, peak = rng.uniform(2, 12), rng.uniform(5, 30)
        h = np.maximum(h, peak * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                        / (2 * (r / 2) ** 2)))
    h[40:70, 100:160] = np.maximum(h[40:70, 100:160], 7.5)
    h[:20, n - 26:] = 12.0
    noise = rng.normal(0, 0.05, h.shape) * (rng.random(h.shape) < 0.3)
    return (h + noise).astype(np.float32)


@pytest.mark.parametrize("sigma", [0.5, 1.0, 2.0])
def test_gaussian_blur_matches_jax(sigma):
    h = synthetic_ndsm(0, 96)
    got = tvor.gaussian_blur(torch.from_numpy(h), sigma).numpy()
    want = np.asarray(jvor.gaussian_blur(jnp.asarray(h), sigma))
    assert got.dtype == np.float32 and got.shape == h.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * want.max())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_find_crown_seeds_equal_jax(seed):
    h = synthetic_ndsm(seed)
    smooth, seeds = tvor.find_crown_seeds(torch.from_numpy(h))
    js, jm = jvor.find_crown_seeds(jnp.asarray(h))
    js, jm = np.asarray(js), np.asarray(jm)
    assert seeds.dtype == torch.bool
    np.testing.assert_array_equal(seeds.numpy(), jm)
    np.testing.assert_allclose(smooth.numpy(), js, rtol=0,
                               atol=1e-6 * js.max())
    assert 20 < jm.sum()
    assert jm[40:70, 100:160].any() and jm[:20, -26:].any()   # plateaus
    assert jm[0].any() or jm[-1].any() or jm[:, 0].any() or jm[:, -1].any()


def _write_ndsm(path, seed, n=256):
    write_geotiff(str(path), synthetic_ndsm(seed, n),
                  Affine.from_origin(*ORIGIN, 1.0, 1.0), crs=25832)


def _assert_same_layer(got_path, want_path):
    got, gp, gs = read_gpkg(got_path)
    want, wp, ws = read_gpkg(want_path)
    assert gs == ws == 25832 and len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a[0][0]), np.asarray(b[0][0]),
                                   rtol=0, atol=1e-9)
    for p, q in zip(gp, wp):
        assert list(p) == list(q)
        for key in q:
            assert p[key] == pytest.approx(q[key], rel=1e-5), key


@pytest.mark.parametrize("seed", [0, 4])
def test_voronoi_labels_match_jax(tmp_path, seed):
    tif = tmp_path / "ndsm.tif"
    _write_ndsm(tif, seed)
    got = tvor.generate_voronoi_labels(str(tif), str(tmp_path / "port.gpkg"),
                                       device="cpu")
    want = jvor.generate_voronoi_labels(str(tif), str(tmp_path / "jax.gpkg"))
    assert got == want > 10
    _assert_same_layer(str(tmp_path / "port.gpkg"), str(tmp_path / "jax.gpkg"))


@pytest.mark.parametrize("seed", [1, 5])
def test_region_grow_labels_match_jax(tmp_path, seed, jax_native):
    tif = tmp_path / "ndsm.tif"
    _write_ndsm(tif, seed)
    got = tsam.generate_region_grow_labels(
        str(tif), str(tmp_path / "port.gpkg"), device="cpu")
    want = jsam.generate_region_grow_labels(str(tif),
                                            str(tmp_path / "jax.gpkg"))
    assert got == want > 10
    _assert_same_layer(str(tmp_path / "port.gpkg"), str(tmp_path / "jax.gpkg"))


def test_flat_ground_gives_no_labels(tmp_path):
    tif = tmp_path / "flat.tif"
    write_geotiff(str(tif), np.zeros((40, 40), np.float32),
                  Affine.identity(), crs=25832)
    assert tvor.generate_voronoi_labels(str(tif), str(tmp_path / "v.gpkg"),
                                        device="cpu") == 0
    assert tsam.generate_region_grow_labels(str(tif), str(tmp_path / "r.gpkg"),
                                            device="cpu") == 0
    assert read_gpkg(str(tmp_path / "v.gpkg"))[0] == []


def test_cuda_without_a_card_raises(tmp_path):
    """No fallback: the default device is the card."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device works")
    tif = tmp_path / "ndsm.tif"
    _write_ndsm(tif, 0, 32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvor.generate_voronoi_labels(str(tif), str(tmp_path / "v.gpkg"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsam.generate_region_grow_labels(str(tif), str(tmp_path / "r.gpkg"))


def _ring(rng, c, rad, k=16):
    ang = np.sort(rng.uniform(0, 2 * np.pi, k))
    r = rad * rng.uniform(0.8, 1.2, k)
    return np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1)


def test_clean_crowns_equal_jax():
    """Best crown per box, clipped to the box under the IoU threshold, the
    box itself when nothing overlaps: the same rings and flags."""
    rng = np.random.default_rng(2)
    crowns = [_ring(rng, rng.uniform(0, 100, 2), rng.uniform(2, 8))
              for _ in range(40)] + [np.zeros((2, 2))]
    boxes = []
    for c in crowns[:30]:
        x0, y0 = c.min(0) + rng.normal(0, 1.5, 2)
        x1, y1 = c.max(0) + rng.normal(0, 1.5, 2)
        boxes.append([x0, y0, max(x1, x0 + 1), max(y1, y0 + 1)])
    boxes += [[200, 200, 210, 210], [50, 50, 51, 51]]
    flags = set()
    for thr in (0.3, 0.5, 0.9):
        got, gf = tboxes.clean_crowns(crowns, boxes, thr)
        want, wf = jboxes.clean_crowns(crowns, boxes, thr)
        assert gf == wf and len(got) == len(want) == len(boxes)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        flags |= set(gf)
    assert flags == {"crown", "clipped", "box"}


def _rgb_scene(rng, n=160):
    """RGB image: dark-green discs on a lighter ground -> (image, boxes)."""
    img = rng.normal([150, 140, 120], 10, (n, n, 3))
    yy, xx = np.mgrid[0:n, 0:n]
    boxes = []
    for _ in range(14):
        cy, cx, r = rng.uniform(10, n - 10), rng.uniform(10, n - 10), \
            rng.uniform(4, 12)
        inside = (yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2
        img[inside] = rng.normal([60, 140, 50], 8, (inside.sum(), 3))
        boxes.append([cx - r - 1, cy - r - 1, cx + r + 1, cy + r + 1])
    return np.clip(img, 0, 255).astype(np.uint8), np.asarray(boxes)


def test_autolabel_image_with_region_grow_equals_jax(jax_native):
    rng = np.random.default_rng(3)
    img, boxes = _rgb_scene(rng)
    t = Affine.from_origin(*ORIGIN, 0.2, 0.2)
    for transform in (None, t):
        got, gf = tboxes.autolabel_image(img, boxes,
                                         tsam.region_grow_mask_generator,
                                         transform=transform)
        want, wf = jboxes.autolabel_image(img, boxes,
                                          jsam.region_grow_mask_generator,
                                          transform=transform)
        assert gf == wf and gf.count("crown") > 5
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tsam.region_grow_mask_generator(img[..., 1], boxes, channel=0),
        jsam.region_grow_mask_generator(img[..., 1], boxes, channel=0))


def _write_cambridge_dir(root, rng):
    """Two RGB images with their per-image annotation GPKGs (the discs'
    polygons, geo coordinates), and one image without annotations."""
    (root / "img").mkdir()
    (root / "ann").mkdir()
    for k, stem in enumerate(("site_a", "site_b", "site_c")):
        img, boxes = _rgb_scene(rng)
        t = Affine.from_origin(ORIGIN[0] + 100 * k, ORIGIN[1], 0.2, 0.2)
        write_geotiff(str(root / "img" / f"{stem}.tif"), img, t, crs=25832)
        if stem == "site_c":
            continue
        rings = []
        for x0, y0, x1, y1 in boxes:
            c, r = ((x0 + x1) / 2, (y0 + y1) / 2), (x1 - x0) / 2 - 1
            a = np.linspace(0, 2 * np.pi, 20, endpoint=False)
            gx, gy = t.apply(c[0] + r * np.cos(a), c[1] + r * np.sin(a))
            rings.append(np.stack([gx, gy], 1))
        write_gpkg(str(root / "ann" / f"{stem}.gpkg"), rings,
                   [{} for _ in rings], srs_id=25832)


def test_cambridge_flow_equals_jax(tmp_path, jax_native):
    """``autolabel_and_evaluate`` on one image and ``process_directory``
    on the directory (an image without annotations skipped): equal rows,
    and the same autolabel GPKGs."""
    _write_cambridge_dir(tmp_path, np.random.default_rng(4))
    img, ann = tmp_path / "img" / "site_a.tif", tmp_path / "ann" / "site_a.gpkg"
    got = tcam.autolabel_and_evaluate(str(img), str(ann), iou_threshold=0.4)
    want = jcam.autolabel_and_evaluate(str(img), str(ann), iou_threshold=0.4)
    assert got == want and got["n_crowns"] == 14 and got["f1"] > 0.3
    rows = {}
    for name, mod in (("port", tcam), ("jax", jcam)):
        rows[name] = mod.process_directory(
            str(tmp_path / "img"), str(tmp_path / "ann"),
            str(tmp_path / name))
    assert rows["port"] == rows["jax"]
    assert [r["image"].rsplit("/", 1)[1] for r in rows["port"]] == \
        ["site_a.tif", "site_b.tif"]
    for stem in ("site_a", "site_b"):
        name = f"{stem}_autolabel.gpkg"
        g, gp, _ = read_gpkg(str(tmp_path / "port" / name))
        w, wp, _ = read_gpkg(str(tmp_path / "jax" / name))
        assert gp == wp and len(g) == len(w) == 14
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a[0][0]),
                                          np.asarray(b[0][0]))
    empty = tmp_path / "ann" / "empty.gpkg"
    write_gpkg(str(empty), [], [], srs_id=25832)
    assert tcam.autolabel_and_evaluate(str(img), str(empty)) == \
        jcam.autolabel_and_evaluate(str(img), str(empty))


def test_sam_generator_needs_segment_anything():
    """Where ``segment_anything`` is absent, the SAM adapter raises the JAX
    package's ImportError; its real run needs the package and a
    checkpoint."""
    try:
        import segment_anything  # noqa: F401
        pytest.skip("segment_anything is installed")
    except ImportError:
        pass
    with pytest.raises(ImportError) as got:
        tsam.SamMaskGenerator("sam_vit_h.pth", device="cpu")
    with pytest.raises(ImportError) as want:
        jsam.SamMaskGenerator("sam_vit_h.pth")
    assert str(got.value) == str(want.value)
    assert "segment_anything" in str(got.value)
