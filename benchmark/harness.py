"""What every cell shares: finding a cell's files by name, the device's
identity, the reduction of a profiler trace to busy time, kernel times and
idle gaps, the check that no JAX module was loaded, and the result line."""

from __future__ import annotations

import importlib
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that the process must not hold once the window
# has closed, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "treedetection_tpu")


class Cell:
    """One entry of ``workloads``: its file, its configuration's file and
    the metrics that ``BENCHMARK.json`` gives it."""

    def __init__(self, name: str, root: Path = ROOT):
        bench = root / "benchmark"
        spec = json.loads((root / "BENCHMARK.json").read_text())
        entry = [w for w in spec["workloads"] if w["name"] == name]
        if not entry:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entry[0]
        self.workload = json.loads(
            (bench / "workloads" / f"{name}.json").read_text())
        cfg = [c for c in spec["configs"] if c["name"] == self.entry["config"]]
        self.config = json.loads((root / cfg[0]["file"]).read_text())
        self.model = self.config["model"]
        self.chips = int(self.entry["chips"])

        def mine(metric):
            return name in metric.get("workloads", [name])

        self.end_to_end = [m for m in spec["end_to_end"] if mine(m)]
        self.per_layer = [m for m in spec["per_layer"] if mine(m)]

    def driver(self):
        """The traffic driver module named by the cell."""
        return importlib.import_module(f"traffic.{self.entry['traffic']}")


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read`` (dots in a name become ``_``)."""
    return importlib.import_module(
        f"metrics.{name.replace('.', '_').replace('-', '_')}").read


def forbidden_modules() -> List[str]:
    """Forbidden top-level names present in ``sys.modules``."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in FORBIDDEN if t in tops)


def device_info(count: int) -> Dict[str, Any]:
    import torch
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(count))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak)}


# -- the trace -------------------------------------------------------------------

def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def trace_summary(prof) -> Dict[str, Any]:
    """A finished ``torch.profiler.profile`` -> busy seconds (the union of
    the card's kernel and copy intervals), the traced window (first event
    to last), seconds per device op name, and the longest idle gaps of the
    card, labelled by the innermost host op that spans each."""
    from torch.autograd import DeviceType
    dev: List[Tuple[int, int, str]] = []
    host: List[Tuple[int, int, str]] = []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if dur <= 0:
            continue
        if e.device_type() == DeviceType.CUDA:
            dev.append((start, start + dur, e.name()))
        else:
            host.append((start, start + dur, e.name()))
    every = dev + host
    t0 = min((s for s, _, _ in every), default=0)
    t1 = max((e for _, e, _ in every), default=0)
    busy = _union([(s, e) for s, e, _ in dev])
    ops: Dict[str, int] = {}
    for s, e, name in dev:
        ops[name] = ops.get(name, 0) + (e - s)
    gaps = []
    prev = t0
    for s, e in busy + [(t1, t1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:100]
    shortest = min((ge - gs for gs, ge in gaps), default=0)
    long_host = [h for h in host if h[1] - h[0] >= shortest]
    labels: Dict[str, int] = {}
    for gs, ge in gaps:
        spanning = [h for h in long_host if h[0] <= gs and ge <= h[1]]
        label = (min(spanning, key=lambda h: h[1] - h[0])[2] if spanning
                 else "python (no op)")
        labels[label] = labels.get(label, 0) + (ge - gs)
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "window_s": (t1 - t0) / 1e9,
        "ops": {n: v / 1e9 for n, v in ops.items()},
        "device_ops": sorted(([n, v / 1e9] for n, v in ops.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(([n, v / 1e9] for n, v in labels.items()),
                            key=lambda x: -x[1])[:10],
    }


def profiler():
    """A profiler of the host and the card."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def line(correct: bool, attempted: int, failed: int,
         metrics: Dict[str, Tuple[float, str]], device: Dict[str, Any],
         checks: List[Tuple[str, float, float]],
         breakdown: Optional[Dict[str, Any]] = None) -> str:
    """The result's JSON line; ``checks`` comes last."""
    out: Dict[str, Any] = {
        "correct": bool(correct), "attempted": int(attempted),
        "failed": int(failed),
        "metrics": {k: {"value": v, "unit": u} for k, (v, u) in
                    metrics.items()},
        "device": device,
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return json.dumps(out)
