"""The port's manifests: its flat-YAML reader and writer against PyYAML in
both directions, and the recovery manifests exchanged with the JAX package
(a partial run of one package resumes in the other)."""

import math
import os

import numpy as np
import pytest
import yaml

from treedetection_tpu import preprocessing as jax_pre
from treedetection_tpu import recoveries as jax_rec
from treedetection_tpu_torch import flatyaml
from treedetection_tpu_torch import preprocessing as port_pre
from treedetection_tpu_torch import recoveries as port_rec

AWKWARD = [
    "/data/county 7/tile a.tif", "/x/y:z #1.tif", "a: b", "# comment", "- a",
    "", " ", "  lead", "trail  ", "null", "~", "true", "No", "on", "0.1",
    "1e-05", "1e5", "123", "0123", "1_000", "0x1f", "1:30", "2020-01-01",
    "<<", "=", ".inf", "a #b", "a\nb", "a\n\nb  \n c", "'q'", '"dq"', "\\",
    "a\\", "x" * 79 + " y", ("ab " * 40).strip(), "W\u00e4ldchen/\u20ac.tif",
    "/very/long path/" + "seg ment/" * 30 + "f.tif", "tab\there",
]
PARAMS = {"confidence_threshold": 0.3, "containment_threshold": 0.9,
          "height_threshold": 3, "ndvi_mean_threshold": 0.1,
          "ndvi_var_threshold": 1e-05, "iou_threshold": 0.5,
          "area_threshold": 1, "ndvi_scaling_factor": None,
          "height_scaling_factor": 1.0}
MANIFESTS = {
    "prediction": {"model_path": "/models/my model: v2 #3.npz",
                   "processed_images": sorted(AWKWARD)},
    "prediction_no_model": {"model_path": None, "processed_images": []},
    "stitching": {"completed": ["324125317", "a b", "0123"]},
    "postprocess": {"params": PARAMS, "completed": ["a.gpkg", "b c.gpkg"]},
    "postprocess_empty": {"params": {}, "completed": []},
    "tiling": {"buffer": 20, "tile_width": 50.5, "tile_height": 1e-05,
               "processed_files": ["/d/a.tif", "/d/b #2.tif"]},
    "numbers": {"a": 0, "b": -5, "c": 10 ** 12, "d": 1e20, "e": -2.5e-07,
                "f": float("inf"), "g": True, "h": False, "i": 123456.789},
    "continue_list": ["a.tif", "b c.tif", "0123"],
    "continue_dict": {"skip": ["a.tif", "/p/q r.tif"]},
    "empty_list": [],
    "empty_dict": {},
}


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("name", sorted(MANIFESTS))
def test_flatyaml_interoperates_with_pyyaml(name):
    """What the port writes, PyYAML reads to the same object; what PyYAML
    writes (quoting, folding at 80 columns, 1.0e-05 floats), the port reads
    to the same object; and the port reads its own text back."""
    data = MANIFESTS[name]
    ours = flatyaml.dumps(data)
    assert _same(yaml.safe_load(ours), data), ours
    assert _same(flatyaml.loads(ours), data), ours
    theirs = yaml.safe_dump(data)
    assert _same(flatyaml.loads(theirs), data), theirs


def test_flatyaml_scalars_resolve_as_pyyaml_does():
    text = ("a: 1e-05\nb: 1.0e-05\nc: yes\nd: ~\ne:\nf: 012\n")
    with pytest.raises(flatyaml.FlatYamlError):
        flatyaml.loads(text)                    # 012 is octal to YAML 1.1
    text = text.replace("f: 012\n", "f: '012'\n")
    assert flatyaml.loads(text) == yaml.safe_load(text) == {
        "a": "1e-05", "b": 1e-05, "c": True, "d": None, "e": None,
        "f": "012"}
    assert flatyaml.loads("") is None and flatyaml.loads("# only\n") is None
    assert flatyaml.loads("k: .nan\n")["k"] != flatyaml.loads("k: .nan\n")["k"]


@pytest.mark.parametrize("text", [
    "a: [1, 2]\n", "a: {b: 1}\n", "a: &x 1\n", "a: !!str 1\n", "a: |\n  x\n",
    "a:\n  b:\n    c: 1\n", "a: 1\na: 2\n", "\ta: 1\n", "a: 'open\n",
    "- a\nb: 1\n", "a:\n  - [x]\n"])
def test_flatyaml_refuses_what_it_does_not_cover(text):
    with pytest.raises(flatyaml.FlatYamlError):
        flatyaml.loads(text)


def test_flatyaml_fuzz_against_pyyaml():
    rng = np.random.default_rng(0)
    alphabet = list("abcXYZ019 :#'\"\\/-_.,[]{}!&*?|>%@`~\u00e4\u20ac\t")

    def text():
        n = int(rng.choice([0, 1, 3, 10, 40, 90, 150]))
        return "".join(rng.choice(alphabet, n))

    def scalar():
        r = rng.random()
        if r < 0.5:
            return AWKWARD[int(rng.integers(len(AWKWARD)))] \
                if rng.random() < 0.5 else text()
        if r < 0.6:
            return None
        if r < 0.7:
            return int(rng.choice([0, 1, -5, 10 ** 12]))
        if r < 0.9:
            return float(rng.choice([0.1, 1e-05, 0.3, 3.0, 1e20, -2.5e-07]))
        return bool(rng.random() < 0.5)

    for _ in range(1500):
        data = {}
        for key in rng.choice(["completed", "params", "model_path", "skip",
                               "buffer", "k e y"], int(rng.integers(0, 5)),
                              replace=False):
            r = rng.random()
            if r < 0.4:
                data[str(key)] = [scalar() for _ in range(rng.integers(0, 6))]
            elif r < 0.6:
                data[str(key)] = {k: scalar() for k in rng.choice(
                    ["a", "b_c", "iou_threshold"], int(rng.integers(0, 4)),
                    replace=False).tolist()}
            else:
                data[str(key)] = scalar()
        ours, theirs = flatyaml.dumps(data), yaml.safe_dump(data)
        assert _same(yaml.safe_load(ours), data), ours
        assert _same(flatyaml.loads(theirs), data), theirs


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_manifest_sets_cross_the_packages(tmp_path, writer, reader):
    """A manifest set written by one package resumes the other."""
    w = {"jax": (jax_rec, jax_pre), "port": (port_rec, port_pre)}[writer]
    r = {"jax": (jax_rec, jax_pre), "port": (port_rec, port_pre)}[reader]
    out = tmp_path / "out dir: #1"
    tiles = tmp_path / "tiles"
    images = [str(tmp_path / "rgb" / "324125317.tif"),
              str(tmp_path / "rgb" / "county 7" / "a b.tif")]
    # prediction: the manifest lists both, one has its files on disk
    pred_dir = out / "324125317"
    pred_dir.mkdir(parents=True)
    (pred_dir / "Prediction_x_0_0_50_20_25832.json").write_text("[]")
    w[0].save_prediction_recovery_data(str(out), "/m/model v2.npz", images)
    assert r[0].load_prediction_recovery_data(
        str(out), "/m/model v2.npz") == [images[0]]
    assert r[0].load_prediction_recovery_data(str(out), "/m/other.npz") == []
    tile_meta = {images[0]: {"t1": {}, "t2": {"only_forest": True}}}
    assert r[0].load_prediction_recovery_data(
        str(out), "/m/model v2.npz", tile_meta, "only_forest") == [images[0]]
    assert r[0].load_prediction_recovery_data(
        str(out), "/m/model v2.npz", tile_meta) == []    # 1 file < 2 tiles
    # stitching and fusion
    w[0].save_stitching_recovery_data(str(out), ["b", "a", "a"])
    assert r[0].load_stitching_recovery_data(str(out)) == ["a", "b"]
    w[0].save_fusion_recovery_data(str(out), ["x y"])
    assert r[0].load_fusion_recovery_data(str(out)) == ["x y"]
    # postprocess: a parameter mismatch resets
    params = w[0].postprocess_params(dict(PARAMS, unrelated=1))
    assert params == PARAMS
    w[0].save_postprocess_recovery_data(str(out), params, ["a.gpkg"])
    assert r[0].load_postprocess_recovery_data(str(out), dict(PARAMS)) == \
        ["a.gpkg"]
    assert r[0].load_postprocess_recovery_data(
        str(out), dict(PARAMS, iou_threshold=0.6)) == []
    # tiling manifest: parameters and the metadata files must be there
    tiles.mkdir()
    (tiles / "324125317.json").write_text("{}")
    w[1].save_recovery_data(str(tiles), 20, 50, 50.5, images)
    assert r[1].load_recovery_data(str(tiles), 20, 50, 50.5) == [images[0]]
    assert r[1].load_recovery_data(str(tiles), 10, 50, 50.5) == []


def test_shards_merge_and_host_id_names_the_file(tmp_path, monkeypatch):
    monkeypatch.setenv("TREEDETECTION_HOST_ID", "1")
    port_rec.save_stitching_recovery_data(str(tmp_path), ["b"])
    monkeypatch.setenv("TREEDETECTION_HOST_ID", "0")
    jax_rec.save_stitching_recovery_data(str(tmp_path), ["a"])
    monkeypatch.delenv("TREEDETECTION_HOST_ID")
    assert sorted(os.listdir(tmp_path)) == ["stitching_recovery.0.yaml",
                                            "stitching_recovery.1.yaml"]
    assert port_rec.load_stitching_recovery_data(str(tmp_path)) == ["a", "b"]
    assert jax_rec.load_stitching_recovery_data(str(tmp_path)) == ["a", "b"]
    assert port_rec._shard_suffix() == ""
    # a damaged shard is skipped, not fatal
    (tmp_path / "stitching_recovery.2.yaml").write_text("completed: [a, {b\n")
    assert port_rec.load_stitching_recovery_data(str(tmp_path)) == ["a", "b"]


def test_continue_file_both_shapes(tmp_path):
    as_list = tmp_path / "c1.yml"
    as_list.write_text(yaml.safe_dump(["a.tif", "b c.tif", 17]))
    as_dict = tmp_path / "c2.yml"
    as_dict.write_text(yaml.safe_dump({"skip": ["a.tif", "/p/q r.tif"]}))
    for path in (as_list, as_dict):
        assert port_rec.load_continue_file(str(path)) == \
            jax_rec.load_continue_file(str(path))
    assert port_rec.load_continue_file(str(as_list)) == ["a.tif", "b c.tif",
                                                         "17"]
    assert port_rec.load_continue_file(None) == []
    assert port_rec.load_continue_file(str(tmp_path / "missing.yml")) == []
    bad = tmp_path / "bad.yml"
    bad.write_text("skip: [a, {b\n")
    assert port_rec.load_continue_file(str(bad)) == []
