"""Shared fixtures of the benchmark's own tests: a copy of the benchmark
with its cells cut to a size that the CPU runs in seconds."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def small_copy(dst: Path) -> Path:
    """``BENCHMARK.json`` and ``benchmark/`` under ``dst``, with the
    configuration at a 256px input and the R50 depth, and the stream at 8
    tiles."""
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(BENCH, dst / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    for f in (dst / "benchmark" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["model"].update(input_size=256, depth=50, rpn_pre_nms_topk=200,
                          rpn_post_nms_topk=64, max_detections=20)
        c["program"].update(model_input_size=256, model_depth=50,
                            rpn_pre_nms_topk=200, rpn_post_nms_topk=64,
                            max_detections=20, batch_size=4)
        f.write_text(json.dumps(c))
    w = dst / "benchmark" / "workloads"
    t = json.loads((w / "r101_tile_stream.json").read_text())
    t["traffic_params"].update(sheet_px=1000, tiles=8, judged_batches=2,
                               traced_batches=1, marked_batches=1)
    (w / "r101_tile_stream.json").write_text(json.dumps(t))
    return dst


@pytest.fixture
def small_root(tmp_path):
    return small_copy(tmp_path)
