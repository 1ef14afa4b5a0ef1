"""A cell, a configuration and a per-layer metric are found by name: a
throwaway cell file and metric file added to a copy of the benchmark are
picked up with no existing file edited."""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import textwrap
from pathlib import Path

from conftest import small_copy


def _digests(root: Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_and_metric_are_found_without_edits(tmp_path):
    root = small_copy(tmp_path)
    before = _digests(root / "benchmark")
    bench = root / "benchmark"
    (bench / "workloads" / "r50_tile_stream_tmp.json").write_text(json.dumps(
        {**json.loads((bench / "workloads" / "r101_tile_stream.json")
                      .read_text()), "name": "r50_tile_stream_tmp",
         "config": "mask_rcnn_r101_fpn"}))
    (bench / "metrics" / "batches_tmp.py").write_text(textwrap.dedent('''
        def read(records):
            return float(records["batches"])
    '''))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "r50_tile_stream_tmp",
                              "config": "mask_rcnn_r101_fpn",
                              "traffic": "tile_stream", "chips": 1,
                              "why": "a throwaway cell"})
    spec["per_layer"].append({"name": "batches_tmp", "unit": "batches",
                              "better": "higher", "source": "host_clock",
                              "layer": "device", "moves": "tiles_per_s",
                              "workloads": ["r50_tile_stream_tmp"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    probe = textwrap.dedent(f'''
        import sys
        sys.path[:0] = [{str(bench)!r}, {str(root)!r}]
        import harness
        cell = harness.Cell("r50_tile_stream_tmp", harness.ROOT)
        assert harness.ROOT == __import__("pathlib").Path({str(root)!r})
        print(cell.driver().__name__, cell.model["depth"],
              [m["name"] for m in cell.per_layer],
              [m["name"] for m in cell.end_to_end],
              harness.metric_reader("batches_tmp")({{"batches": 7}}))
    ''')
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [
        "traffic.tile_stream", "50", "['batches_tmp']",
        "['tiles_per_s',", "'batch_ms_p95',", "'setup_s']", "7.0"]
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before


def test_every_cell_names_files_that_exist():
    from harness import ROOT, Cell
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        cell = Cell(w["name"])
        assert cell.workload["name"] == w["name"]
        assert cell.workload["config"] == w["config"]
        assert cell.driver().__name__ == f"traffic.{w['traffic']}"
        assert cell.end_to_end and cell.per_layer
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    for m in spec["per_layer"]:
        from harness import metric_reader
        assert callable(metric_reader(m["name"]))
