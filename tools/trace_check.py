"""Checks of the serving path's spans (``utils.profiling``) on the card, on
a benchmark cell (``--cell``, default ``r101_tile_stream``: its seeded
weights and tiles):

    python3 tools/trace_check.py [--cell NAME] [--seed N]
        [--parts syncs,off,chrome] [--layouts flat,levels,resident]
        [--out DIR]

Kernel launches are read from the one launch counter,
``treedetection_tpu_torch.build.launch_counts``.

``syncs``: under ``torch.cuda.set_sync_debug_mode("warn")``, served batches
with tracing on: every synchronizing call of the device thread, its site,
and whether it lies inside an open ``sync.<site>`` span.  ``off``: one
served batch with tracing off: the ``record_function`` calls, the CUDA
events made and the device thread's syncs, against the same batch with
tracing on.  Both run under each pooler layout of ``--layouts`` (K1, K5,
K6).  ``chrome``: the cell's traced batches under
``utils.profiling.profile_trace``; the card's idle gaps in its Chrome
trace, each part given to the innermost span open on the device thread,
and the device thread's launches (kernels, copies, fills) per batch, by the
innermost span that made them.

One JSON line per part on standard output, then a verdict line.  Exits 1
when a sync of the device thread lies outside every sync span, when the
batch record's sync count differs from the syncs seen, when a served batch
copies level geometry to the card (``sync.pool_h2d``) or checks K1's columns
on the host (``sync.k1_cols``), when it does not launch the pooler's
geometry and exact-tail kernels and its layout's patch kernel twice each
(box and mask pool), when a sync of the device thread lies inside a
ViTDet backbone span (``vit.*``), when a ViTDet batch does not launch the
attention kernel once per block (``relpos.window``, ``relpos.global``:
20 and 4 for ViT-L), or when tracing off
enters a ``record_function``, makes a CUDA event beyond the batch's
arrival events, makes a sync that tracing on does not count, or leaves
anything in ``TRACE``.  With ``--out``, the Chrome trace, gzipped, there.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import glob
import gzip
import importlib
import json
import os
import shutil
import sys
import tempfile
import threading
import traceback
import warnings
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]

import torch  # noqa: E402

from treedetection_tpu_torch.utils import profiling  # noqa: E402

PACKAGE = str(ROOT / "treedetection_tpu_torch")
CELL = "r101_tile_stream"
BACKBONE_PREFIX = "vit."
DEVICE_THREAD = "td-device"
LAYOUT_ENV = {"flat": {}, "levels": {"TD_ROI_FLAT": "0"},
              "resident": {"TD_ROI_RESIDENT": "1"}}
# the patch kernel's launch counter each layout pools with
LAYOUT_KERNEL = {"flat": "k1", "levels": "k5", "resident": "k6"}
# sync spans a served batch must not open at steady state
NO_SYNC_SITES = ("sync.pool_h2d", "sync.k1_cols")
# the CUDA runtime and driver calls that put work on the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


@contextlib.contextmanager
def layout_env(layout: str):
    """The pooler-layout variables of ``layout`` for the block."""
    saved = {k: os.environ.pop(k, None)
             for k in ("TD_ROI_FLAT", "TD_ROI_RESIDENT")}
    os.environ.update(LAYOUT_ENV[layout])
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


# -- open spans, per thread -------------------------------------------------------

_open = threading.local()


def _track_open_spans() -> None:
    """Keep a per-thread stack of the open spans' names."""
    enter, leave = profiling.Span.__enter__, profiling.Span.__exit__

    def tracked_enter(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        stack.append(self.name)
        return enter(self)

    def tracked_exit(self, *exc):
        _open.stack.pop()
        return leave(self, *exc)

    profiling.Span.__enter__ = tracked_enter
    profiling.Span.__exit__ = tracked_exit


def _site(stack) -> str:
    """The innermost frame of the package: ``file:line function``."""
    for frame in reversed(stack):
        if frame.filename.startswith(PACKAGE):
            rel = os.path.relpath(frame.filename, ROOT)
            return f"{rel}:{frame.lineno} {frame.name}"
    frame = stack[-1]
    return f"{frame.filename}:{frame.lineno} {frame.name}"


class SyncLog:
    """Every synchronizing call that ``set_sync_debug_mode("warn")``
    reports, with its site and the sync span open on its thread."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self._show = warnings.showwarning
        self._filters = warnings.filters[:]
        warnings.filterwarnings("always", message=".*synchroniz")
        warnings.showwarning = self._record
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        warnings.showwarning = self._show
        warnings.filters[:] = self._filters
        return False

    def _record(self, message, category, filename, lineno, file=None,
                line=None):
        if "synchroniz" not in str(message):
            return self._show(message, category, filename, lineno, file, line)
        stack = traceback.extract_stack()[:-1]
        open_spans = getattr(_open, "stack", [])
        spans = [s for s in open_spans
                 if s.startswith(profiling.SYNC_PREFIX)]
        backbone = [s for s in open_spans if s.startswith(BACKBONE_PREFIX)]
        self.calls.append({"site": _site(stack),
                           "thread": threading.current_thread().name,
                           "span": spans[-1] if spans else None,
                           "backbone": backbone[-1] if backbone else None})

    def device_calls(self):
        return [c for c in self.calls
                if c["thread"].startswith(DEVICE_THREAD)]

    def summary(self):
        by_site = collections.Counter(
            (c["site"], c["span"], c["thread"]) for c in self.calls)
        return [{"site": s, "span": sp, "thread": t, "n": n}
                for (s, sp, t), n in sorted(by_site.items())]


# -- the cell ---------------------------------------------------------------------

def setup(seed: int, name: str = CELL):
    import harness
    cell = harness.Cell(name)
    traffic = importlib.import_module(f"traffic.{cell.entry['traffic']}")
    state = traffic.setup(cell, seed)
    torch.cuda.synchronize()
    return traffic, state


def serve_one(state, k: int = 0) -> int:
    """One batch through the Predictor's device thread, as the stream
    serves it; waits for its outputs -> its arrival events."""
    pred, forward = state["pred"], state["forward"]
    parts = pred._dispatch.submit(
        forward, state["batches"][k % len(state["batches"])]).result()
    for _, event in parts:
        if event is not None:
            event.synchronize()
    torch.cuda.synchronize()
    return sum(event is not None for _, event in parts)


def _attention_launches(model):
    """The attention kernel's launches a forward makes, by counter: one a
    block, windowed or global (none for a ResNet backbone)."""
    if getattr(model.cfg, "backbone", "resnet") != "vit":
        return {}
    glob = set(model.cfg.vit_global_blocks) & set(range(model.cfg.vit_depth))
    return {"relpos.window": model.cfg.vit_depth - len(glob),
            "relpos.global": len(glob)}


def part_syncs(state, batches: int, layout: str, problems):
    from torch.profiler import ProfilerActivity, profile

    from treedetection_tpu_torch.build import launch_counts
    out = []
    for k in range(batches):
        profiling.trace_reset()
        before = launch_counts()
        with profile(activities=[ProfilerActivity.CPU]):
            with SyncLog() as log:
                serve_one(state, k)
        launched = launch_counts() - before
        attention = {n: launched.pop(n) for n in list(launched)
                     if n.startswith("relpos.")}
        snap = profiling.trace_snapshot()
        record = snap["batches"][-1]
        device = log.device_calls()
        uncovered = [c for c in device if c["span"] is None]
        line = {
            "part": "syncs", "layout": layout, "batch": k,
            "syncs": len(log.calls), "device_thread_syncs": len(device),
            "sync_spans": record["syncs"], "uncovered": len(uncovered),
            "sync_span_counts": {n: c for n, c in snap["counts"].items()
                                 if n.startswith(profiling.SYNC_PREFIX)},
            "roi_launches": dict(launched), "sites": log.summary(),
            "record": record, "attention_launches": attention}
        want_attention = _attention_launches(state["pred"].model)
        if attention != want_attention:
            problems.append(f"{layout} batch {k}: attention launches "
                            f"{attention}, expected {want_attention}")
        in_backbone = [c for c in device if c["backbone"] is not None]
        line["backbone_syncs"] = len(in_backbone)
        if in_backbone:
            problems.append(f"{layout} batch {k}: {len(in_backbone)} syncs "
                            f"inside the backbone's spans "
                            f"({sorted({c['site'] for c in in_backbone})})")
        for site in NO_SYNC_SITES:
            if line["sync_span_counts"].get(site, 0):
                problems.append(f"{layout} batch {k}: "
                                f"{line['sync_span_counts'][site]} {site} "
                                f"syncs at steady state")
        want = {"geometry": 2, "exact_tail": 2, LAYOUT_KERNEL[layout]: 2}
        if {n: c for n, c in launched.items() if c} != want:
            problems.append(f"{layout} batch {k}: pooler launches "
                            f"{launched}, expected {want}")
        if uncovered:
            problems.append(f"{layout} batch {k}: {len(uncovered)} syncs "
                            f"outside a sync span")
        if record["syncs"] != len(device):
            problems.append(f"{layout} batch {k}: {record['syncs']} sync "
                            f"spans for {len(device)} syncs")
        out.append(line)
    return out


def part_off(state, layout: str, problems):
    """Tracing off: what a served batch creates and syncs, against the
    same batch with tracing on."""
    made = collections.Counter()
    rf_classes = (torch.profiler.record_function,
                  torch.autograd.profiler.record_function)
    event_class = torch.cuda.Event

    class CountedRF(rf_classes[0]):
        def __init__(self, *a, **k):
            made["record_function"] += 1
            super().__init__(*a, **k)

    class CountedEvent(event_class):
        def __new__(cls, *a, **k):
            made["cuda_event"] += 1
            return super().__new__(cls, *a, **k)

    torch.profiler.record_function = CountedRF
    torch.autograd.profiler.record_function = CountedRF
    torch.cuda.Event = CountedEvent
    try:
        assert not profiling.tracing()
        profiling.trace_reset()
        with SyncLog() as log:
            arrivals = serve_one(state, 1)
        off = dict(made)
        off_syncs = len(log.device_calls())
        snap_off = profiling.trace_snapshot()
        made.clear()
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]):
            with SyncLog() as log:
                serve_one(state, 1)
        on = dict(made)
        on_syncs = len(log.device_calls())
        on_spans = profiling.trace_snapshot()["batches"][-1]["syncs"]
    finally:
        torch.profiler.record_function = rf_classes[0]
        torch.autograd.profiler.record_function = rf_classes[1]
        torch.cuda.Event = event_class
    if off.get("record_function", 0):
        problems.append(f"{layout}: tracing off entered "
                        f"{off['record_function']} record_function calls")
    if off.get("cuda_event", 0) != arrivals:
        problems.append(f"{layout}: tracing off made {off.get('cuda_event')} "
                        f"CUDA events for {arrivals} arrival events")
    if off_syncs != on_spans:
        problems.append(f"{layout}: tracing off made {off_syncs} syncs, "
                        f"tracing on counted {on_spans}")
    if snap_off["batches"] or snap_off["spans"] or snap_off["counts"]:
        problems.append(f"{layout}: tracing off recorded into TRACE")
    return [{"part": "off", "layout": layout, "off": off,
             "arrival_events": arrivals, "off_syncs": off_syncs,
             "off_records": len(snap_off["batches"]),
             "off_spans": len(snap_off["spans"]), "on": on,
             "on_syncs": on_syncs, "on_sync_spans": on_spans}]


# -- the Chrome trace ----------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def idle_attribution(trace_path: str):
    """The card's idle gaps within the device thread's forwards, each
    instant given to the innermost span open on that thread then."""
    with open(trace_path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    # the spans on the host's threads (the card's copies of them are
    # ``gpu_user_annotation``)
    forwards = [e for e in events if e.get("name") == "predictor.forward"
                and e.get("cat") == "user_annotation"]
    if not forwards:
        return {"error": "no predictor.forward span in the trace"}
    tid = collections.Counter(e["tid"] for e in forwards).most_common(1)[0][0]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("tid") == tid and e.get("cat") == "user_annotation"]
    busy = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") in DEVICE_CATS)
    t0 = min(s for s, _, _ in spans)
    t1 = max(e for s, e, n in spans if n == "predictor.forward")
    merged = []
    for s, e in busy:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps, prev = [], t0
    for s, e in merged + [[t1, t1]]:
        s, e = max(s, t0), min(e, t1)
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    labels = collections.Counter()
    for gs, ge in gaps:
        inside = [(max(s, gs), min(e, ge), e - s, n) for s, e, n in spans
                  if s < ge and e > gs]
        cuts = sorted({gs, ge} | {a for a, _, _, _ in inside}
                      | {b for _, b, _, _ in inside})
        for a, b in zip(cuts, cuts[1:]):
            holding = [(w, n) for s, e, w, n in inside if s <= a and b <= e]
            labels[min(holding)[1] if holding else "(no span)"] += b - a
    window = t1 - t0
    idle = sum(labels.values())
    # launches: the device thread's runtime calls that put work on the card,
    # each given to the innermost span open at its start
    launches = collections.Counter()
    for e in events:
        if e.get("tid") == tid and e.get("name") in LAUNCH_CALLS \
                and t0 <= e["ts"] <= t1:
            holding = [(se - ss, n) for ss, se, n in spans
                       if ss <= e["ts"] <= se]
            launches[min(holding)[1] if holding else "(no span)"] += 1
    n_fwd = len(forwards)
    return {"window_ms": window / 1e3, "idle_ms": idle / 1e3,
            "idle_share": idle / window if window else None,
            "forwards": n_fwd,
            "idle_by_span_ms": {n: v / 1e3 for n, v in labels.most_common()},
            "launches_per_batch": sum(launches.values()) / n_fwd,
            "launches_per_batch_by_span": {
                n: v / n_fwd for n, v in launches.most_common()}}


def part_chrome(traffic, state, out_dir: Optional[Path]):
    work = Path(tempfile.mkdtemp(prefix="trace_check_"))
    try:
        profiling.trace_reset()
        with profiling.profile_trace(str(work)):
            traffic.traced(state)
        snap = profiling.trace_snapshot()
        path = glob.glob(str(work / "trace_*.json"))[0]
        summary = idle_attribution(path)
        if out_dir is not None:
            out_dir.mkdir(parents=True, exist_ok=True)
            with open(path, "rb") as src, \
                    gzip.open(out_dir / "profile_trace.json.gz", "wb") as dst:
                shutil.copyfileobj(src, dst)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    spans = {n: v for n, v in snap["spans"].items()}
    return [{"part": "chrome", "batches": len(snap["batches"]),
             "attribution": summary, "span_seconds": spans}]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", default=CELL,
                    help="the benchmark cell whose weights and tiles serve")
    ap.add_argument("--seed", type=int, default=2718281828)
    ap.add_argument("--parts", default="syncs,off,chrome")
    ap.add_argument("--layouts", default="flat",
                    help="pooler layouts of the syncs and off parts: "
                         + ",".join(LAYOUT_ENV))
    ap.add_argument("--batches", type=int, default=2,
                    help="served batches checked by the syncs part")
    ap.add_argument("--out", default=None,
                    help="directory for the chrome part's gzipped trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_check: needs a CUDA device", file=sys.stderr)
        return 3
    parts = args.parts.split(",")
    layouts = args.layouts.split(",")
    if set(layouts) - set(LAYOUT_ENV):
        ap.error(f"unknown layouts {sorted(set(layouts) - set(LAYOUT_ENV))}")
    _track_open_spans()
    traffic, state = setup(args.seed, args.cell)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__}), flush=True)
    problems = []
    lines = []
    for layout in layouts:
        with layout_env(layout):
            serve_one(state)     # builds the layout's pooler library
            if "syncs" in parts:
                lines += part_syncs(state, args.batches, layout, problems)
            if "off" in parts:
                lines += part_off(state, layout, problems)
    if "chrome" in parts:
        lines += part_chrome(traffic, state,
                             Path(args.out) if args.out else None)
    lines.append({"part": "verdict", "ok": not problems,
                  "problems": problems})
    for line in lines:
        print(json.dumps(line), flush=True)
    traffic.release(state)
    traffic.close(state)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
