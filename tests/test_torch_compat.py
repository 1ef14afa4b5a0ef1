"""The port's ``compat.py`` against the JAX package's ``compat.py``.

Both sides are numpy, so every comparison is exact equality.  Masks, crowns
and tile files are made from a seed.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from treedetection_tpu import compat as jax_compat
from treedetection_tpu_torch import compat, stitching
from treedetection_tpu_torch.vector import read_gpkg, write_gpkg


def circle(cx, cy, r, n=24):
    a = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([cx + r * np.cos(a), cy + r * np.sin(a)], axis=1)


def _blob_mask(rng, h, w, n_blobs=3):
    yy, xx = np.mgrid[0:h, 0:w]
    mask = np.zeros((h, w), dtype=np.uint8)
    for _ in range(n_blobs):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(2, h / 3), rng.uniform(2, w / 3)
        mask |= (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1).astype(
            np.uint8)
    return mask


def _rle_string(counts):
    """pycocotools' compressed ``counts`` string (delta coding from the third
    run on, 5 bits per character with a continuation bit, offset 48): the
    encoder for the decoder under test."""
    out = []
    for i, x in enumerate(counts):
        x = int(x)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


MASK_CASES = [(0, 17, 23), (1, 40, 31), (2, 8, 8), (3, 64, 9)]


@pytest.mark.parametrize("seed,h,w", MASK_CASES)
def test_rle_round_trips_in_list_and_string_form(seed, h, w):
    rng = np.random.default_rng(seed)
    for mask in (_blob_mask(rng, h, w), np.ones((h, w), np.uint8),
                 np.zeros((h, w), np.uint8),
                 (rng.random((h, w)) < 0.5).astype(np.uint8)):
        rle = compat.rle_encode(mask)
        assert rle == jax_compat.rle_encode(mask)
        assert rle["size"] == [h, w] and sum(rle["counts"]) == h * w
        np.testing.assert_array_equal(compat.rle_decode(rle), mask)
        np.testing.assert_array_equal(compat.rle_decode(rle),
                                      jax_compat.rle_decode(rle))
        packed = {"size": [h, w], "counts": _rle_string(rle["counts"])}
        np.testing.assert_array_equal(compat.rle_decode(packed), mask)
        np.testing.assert_array_equal(jax_compat.rle_decode(packed), mask)
        as_bytes = dict(packed, counts=packed["counts"].encode())
        np.testing.assert_array_equal(compat.rle_decode(as_bytes), mask)


@pytest.mark.parametrize("seed,h,w", MASK_CASES)
def test_polygon_from_mask_equals_jax(seed, h, w):
    rng = np.random.default_rng(100 + seed)
    mask = _blob_mask(rng, h, w)
    flat = compat.polygon_from_mask(mask)
    assert flat == jax_compat.polygon_from_mask(mask)
    assert len(flat) >= 8 and flat[:2] == flat[-2:]          # closed ring
    assert compat.polygon_from_mask(np.zeros((h, w), np.uint8)) == \
        jax_compat.polygon_from_mask(np.zeros((h, w), np.uint8)) == []


def test_element_is_near_border_equals_jax():
    raster = (0.0, 0.0, 100.0, 80.0)
    rng = np.random.default_rng(5)
    boxes = [(0.5, 10, 8, 18), (50, 50, 60, 60), (92, 10, 99.5, 20),
             (10, 0.2, 20, 8), (10, 70, 20, 79.5), (1.0, 1.0, 99.0, 79.0)]
    for _ in range(10):
        x, y = rng.uniform(0, 90), rng.uniform(0, 70)
        boxes.append((x, y, x + rng.uniform(1, 10), y + rng.uniform(1, 10)))
    seen = set()
    for box in boxes:
        for eps in (1.0, 0.1, 5.0):
            got = compat.element_is_near_border(box, raster, eps)
            assert got == jax_compat.element_is_near_border(box, raster, eps)
            seen.add(got)
    assert seen == {True, False}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clean_crowns_equals_jax(seed):
    rng = np.random.default_rng(seed)
    crowns, scores = [], []
    for _ in range(30):
        cx, cy = rng.uniform(0, 60, 2)
        crowns.append(circle(cx, cy, rng.uniform(2, 6)))
        scores.append(float(rng.uniform(0.05, 1.0)))
        if rng.random() < 0.4:        # a near-duplicate with another score
            crowns.append(circle(cx + 0.3, cy - 0.2, rng.uniform(2, 6)))
            scores.append(float(rng.uniform(0.05, 1.0)))
    got = compat.clean_crowns(crowns, scores, iou_threshold=0.5,
                              confidence=0.2)
    want = jax_compat.clean_crowns(crowns, scores, iou_threshold=0.5,
                                   confidence=0.2)
    assert got[1] == want[1] and 0 < len(got[0]) < len(crowns)
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    assert compat.clean_crowns([], []) == ([], [])


def _tile_files(root: Path, rng):
    """Two prediction files, one with polygons and one with RLE masks (list
    and string counts), and their tile metadata."""
    meta, files = {}, []
    for k, tx in enumerate((100, 150)):
        tile_id = f"img_{tx}_200_50_20_25832"
        meta[tile_id] = {"transform": [0.2, 0.0, float(tx - 20), 0.0, -0.2,
                                       270.0], "crs": 25832}
        preds = []
        for j in range(4):
            if k == 0:
                preds.append({"score": float(rng.uniform(0.3, 1)),
                              "polygon_coords": [circle(
                                  tx + rng.uniform(5, 45),
                                  200 + rng.uniform(5, 45),
                                  rng.uniform(2, 6)).tolist()]})
            else:
                rle = compat.rle_encode(_blob_mask(rng, 450, 450, n_blobs=1))
                if j % 2:
                    rle["counts"] = _rle_string(rle["counts"])
                preds.append({"score": float(rng.uniform(0.3, 1)),
                              "segmentation": rle})
        preds.append({"score": 0.5})                 # neither form: skipped
        path = root / f"Prediction_{tile_id}.json"
        path.write_text(json.dumps(preds))
        files.append(str(path))
    return files, meta


def test_project_to_geojson_equals_jax(tmp_path):
    files, meta = _tile_files(tmp_path, np.random.default_rng(7))
    ours = compat.project_to_geojson(files, meta, str(tmp_path / "ours"))
    theirs = jax_compat.project_to_geojson(files, meta,
                                           str(tmp_path / "theirs"))
    assert [Path(p).name for p in ours] == [Path(p).name for p in theirs]
    assert len(ours) == 2
    for a, b in zip(ours, theirs):
        assert Path(a).read_bytes() == Path(b).read_bytes()
        assert len(json.loads(Path(a).read_text())["features"]) == 4
    # a file without metadata is skipped by both
    assert compat.project_to_geojson(files, {}, str(tmp_path / "none")) == []


def test_rle_tile_json_stitched_like_jax(tmp_path):
    """A tile JSON whose crowns carry an RLE ``segmentation`` (detectree2
    format) goes through ``stitch_tile_file`` of both packages: the same
    rings and scores, and at least one crown kept."""
    from treedetection_tpu import stitching as jax_stitching
    files, _ = _tile_files(tmp_path, np.random.default_rng(9))
    # RLE rings are in pixel coordinates of a 450 px tile: name the tile so
    # that its shrunk box covers them
    rle_file = tmp_path / "Prediction_img_20_20_410_20_25832.json"
    rle_file.write_text(Path(files[1]).read_text())
    kept = 0
    for f in (files[0], str(rle_file)):
        got = stitching.stitch_tile_file(f, 0.2)
        want = jax_stitching.stitch_tile_file(f, 0.2)
        assert got[1] == want[1] and len(got[0]) == len(want[0])
        for a, b in zip(got[0], want[0]):
            np.testing.assert_array_equal(a, b)
        kept += len(got[0])
    assert len(stitching.stitch_tile_file(str(rle_file), 0.2)[0]) > 0
    assert kept >= 4


def test_stitch_crowns_equals_jax(tmp_path):
    rng = np.random.default_rng(11)
    folder = tmp_path / "tiles"
    folder.mkdir()
    for tx in (100, 150):
        rings = [circle(tx + rng.uniform(-25, 75), 200 + rng.uniform(-25, 75),
                        rng.uniform(2, 6), n=40) for _ in range(8)]
        write_gpkg(str(folder / f"img_{tx}_200_50_20_25832.gpkg"), rings,
                   [{"Confidence_score": float(rng.uniform(0.3, 1))}
                    for _ in rings], srs_id=25832)
    got = compat.stitch_crowns(str(folder))
    want = jax_compat.stitch_crowns(str(folder))
    assert got[2] == want[2] == 25832 and got[1] == want[1]
    assert 0 < len(got[0]) < 16                 # the shrunk box dropped some
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        compat.stitch_crowns(str(tmp_path / "missing"))
    assert read_gpkg(str(folder / "img_100_200_50_20_25832.gpkg"))[2] == 25832
