"""The port's ``eval``, ``voronoi`` and ``autolabel`` subcommands print
what the JAX package's print for the same files (``voronoi`` and
``autolabel`` with ``--device cpu``) and fail as they do on inputs that
do not exist; ``bench`` is not ported and exits with code 2."""

import json
import shutil

import numpy as np
import pytest

from treedetection_tpu.cli import main as jmain
from treedetection_tpu_torch.cli import main as tmain
from treedetection_tpu_torch.vector import read_gpkg, write_gpkg

from test_torch_autolabel import (
    _assert_same_layer, _write_cambridge_dir, _write_ndsm)
from test_torch_eval import _pred_gt
from test_torch_jax_native import jax_native  # noqa: F401 (fixture)


def _both(capsys, jax_argv, port_argv):
    assert jmain(jax_argv) == 0
    want = capsys.readouterr().out
    assert tmain(port_argv) == 0
    return capsys.readouterr().out, want


def test_eval_prints_what_jax_prints(tmp_path, capsys):
    preds, scores, gts = _pred_gt(11, n_gt=20, n_fp=5)
    pred, gt = str(tmp_path / "pred.gpkg"), str(tmp_path / "gt.gpkg")
    write_gpkg(pred, preds, [{"Confidence_score": s} for s in scores])
    write_gpkg(gt, gts, [{"TreeHeight": 10.0} for _ in gts])
    for extra in ([], ["--iou", "0.3", "--confidence", "0.6"]):
        got, want = _both(capsys, ["eval", pred, gt] + extra,
                          ["eval", pred, gt] + extra)
        assert got == want
        assert json.loads(got)["tp"] > 0


def test_voronoi_prints_what_jax_prints(tmp_path, capsys):
    tif, out = tmp_path / "ndsm.tif", str(tmp_path / "crowns.gpkg")
    _write_ndsm(tif, 2, 128)
    args = ["voronoi", str(tif), out, "--canopy-threshold", "3.0",
            "--min-seed-height", "4.0"]
    assert jmain(args) == 0
    want = capsys.readouterr().out
    shutil.copy(out, tmp_path / "jax.gpkg")
    assert tmain(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and got.endswith(f" crowns -> {out}\n")
    assert int(got.split()[0]) == len(read_gpkg(out)[0]) > 0
    _assert_same_layer(out, str(tmp_path / "jax.gpkg"))


def test_autolabel_prints_what_jax_prints(tmp_path, capsys, jax_native):
    _write_cambridge_dir(tmp_path, np.random.default_rng(12))
    got, want = _both(
        capsys,
        ["autolabel", str(tmp_path / "img"), str(tmp_path / "ann"),
         str(tmp_path / "jax")],
        ["autolabel", str(tmp_path / "img"), str(tmp_path / "ann"),
         str(tmp_path / "port"), "--device", "cpu"])
    assert got == want and len(json.loads(got)) == 2


def test_bench_exits_2_and_missing_inputs_fail_as_jax(tmp_path, capsys):
    assert tmain(["bench"]) == 2
    assert "item 12" in capsys.readouterr().err
    gone = str(tmp_path / "gone")
    for argv, port_only in (
            (["eval", gone + ".gpkg", gone + "_gt.gpkg"], []),
            (["voronoi", gone + ".tif", str(tmp_path / "v.gpkg")],
             ["--device", "cpu"]),
            (["autolabel", gone + "_img", gone + "_ann",
              str(tmp_path / "out")], ["--device", "cpu"])):
        raised = []
        for main, extra in ((jmain, []), (tmain, port_only)):
            with pytest.raises(Exception) as info:
                main(argv + extra)
            raised.append((type(info.value), str(info.value)))
        assert raised[0] == raised[1], argv
    with pytest.raises(SystemExit):
        tmain([])
