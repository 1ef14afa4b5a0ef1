"""``BENCHMARK.json`` against the benchmark's contract, the result line's
shape, and the run's refusals without a card."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest

from harness import BENCH, ROOT, line

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                    r"projection|head_size|expansion|experts_per")


def test_benchmark_json_keeps_to_the_contract():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert not any(WIDTHS.search(k) for k in c["reduced"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        names.add(c["name"])
    cells = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        cells.add(w["name"])
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    for w in cells:
        mine = [m for m in spec["end_to_end"] if w in m.get("workloads", [w])]
        assert len(mine) >= 2
        assert any(w in m["workloads"] for m in spec["per_layer"])


def test_the_line_ends_with_the_checks():
    text = line(True, 4, 0, {"tiles_per_s": (101.5, "tiles/s")},
                {"platform": "gpu", "kind": "X", "count": 1,
                 "memory_peak_bytes": 5}, [("det_gap", 0.01, 0.1)],
                {"device_ops": [["k", 0.5]], "idle_gaps": []})
    out = json.loads(text)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert out["metrics"]["tiles_per_s"] == {"value": 101.5,
                                             "unit": "tiles/s"}
    assert out["checks"] == {"det_gap": {"value": 0.01, "limit": 0.1}}


@pytest.mark.parametrize("workload", ["r101_tile_stream"])
def test_without_a_card_the_run_prints_no_result(workload):
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", workload,
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_without_the_program_the_run_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "r101_tile_stream",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
