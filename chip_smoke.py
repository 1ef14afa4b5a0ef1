#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Phases (each prints JSON lines; any failure exits non-zero).  ``--phases``
takes a comma-separated subset of
build,kernel,predictor,model,pipeline,pipeline_multihost,warmup,
pipeline_two_model,bench,train,train_sharded,eval,autolabel,trace:

1. build     — compile the port's native libraries from the sources in the
               checkout (one nvcc per CUDA kernel source, g++ for the host
               helpers), all compilers started together; prints each
               kernel's ``ptxas`` lines (registers, spills and shared memory
               of the bf16 kernels of K1, K5 and K6, all ``pool_box_bf16``,
               which must not spill, and of ViTDet's attention kernel).
2. kernel    — K1, K5 and K6 (the flat, per-level and image-resident
               ROIAlign patch poolers; K6 at c_split 1 and 2) against their
               plain PyTorch versions and against each other on the same
               boxes (K5 and K6 bit-equal to K1 in both dtypes) at
               production shapes (box pool N=5120 R=7, mask pool N=1000
               R=14, 1024^2 input at batch 10, C=256), in float32 with TF32
               off and in bfloat16 (K6 also at 1 to 32 boxes per block,
               each bit-equal to K1; K1, K5 and K6 in bfloat16 timed in
               turns); K2/K3 (the pairwise dedupe and containment
               relations, one kernel body, bit-packed and as uint8 masks),
               relation_pairs (their bit-packed blocks compacted to pairs)
               and K4 (the IoU mask) against their plain versions with EXACT
               equality (packed bytes, masks, and pair arrays against
               np.nonzero, order included) at one production row block (8192
               rows x 32768 columns), at ragged and square shapes, on
               adversarial rows and with thresholds <= 0; at the production
               block also the crown filter's whole per-block path as it was
               (uint8 mask, host unpack and nonzero) against the new one
               (bits, pairs on the card) on the same boxes; medians of CUDA
               event timings, the kernels' device time, and the bounds
               computed from this run's inputs; the batched pooler's
               geometry kernel against its plain version run by PyTorch on
               the card, every output field with 0 bit mismatches (the
               phase's boxes, adversarial, huge, sqrt(area) at 224 * 2^k and
               one ulp either side, zero-area and off-image boxes), its
               exact-tail kernel against its plain version within the
               pooler's tolerance (mixed take flags, and every box), each
               timed alone and through its wrapper with its launches, and
               one pooling call's host time and launches; ViTDet's
               attention kernel (``relpos_attention``) at the
               ``vitdet_l_tile_stream`` cell's shapes (batch 10, 64 x 64
               tokens, 16 heads of 64, bf16: 14 x 14 windows with their pad
               keys and the global block), its output against the plain
               version in float32 on the same bf16 inputs (the kernel
               rounds p to bf16 before p.v and the output once), its card,
               alone and plain milliseconds, its bound, and as a yardstick
               only ``F.scaled_dot_product_attention`` with the bias
               materialised (``library_ms``; the port never calls it).
3. predictor — the port's Predictor (R50-FPN, 1024^2, batch 10, 512
               proposals, bf16) on a synthetic 1000x1000 px RGBI GeoTIFF
               tiled into 16 tiles: a first pass, then a timed pass with the
               kernel launch counts reset just before it and read just after;
               then a pass under ``TD_ROI_FLAT=0`` (K5 in place of K1) that
               must write the timed pass's tile files byte for byte; then a
               Predictor over two device entries on the one card
               (``predictor_split``: two replicas and streams, batches of 10
               in chunks of 5), which must write a one-device batch-5
               pass's tile files byte for byte.
4. model     — one batch's real proposals and detections pooled through K1
               and the plain version, and the float32 forward's kept sets with
               each pooler (passed explicitly) and under each of the three
               pooler layouts (``TD_ROI_FLAT``, ``TD_ROI_RESIDENT``).
5. pipeline  — ``process_files`` end to end with a dict config and
               ``TD_PAIRS_DEVICE=1``: a synthetic 1 km^2 sheet (5000x5000 px
               RGBI at 0.2 m, 400 tiles) with its 1 m nDSM, plus an adjacent
               200 m sheet so that a seam strip is cut, tiled and predicted;
               checks the processed GPKG, the K1/K2/K3 and relation_pairs
               launch counts, that the host-grid branch gives the same
               crowns, then runs the device branch's postprocess once more on
               the same stitched layers outside the Predictor's overlap (its
               seconds beside the host grid's, the same crowns, the same
               launch checks), and that a second call predicts nothing.
   pipeline_multihost — ``process_files`` on a copy of phase 5's sheets as
               two hosts: two processes on the one card with torchrun's
               environment, gloo between them, the kernels built by phase 1;
               each host prints its stage seconds, launch counts and the
               all-gathered totals, and the crowns must equal phase 5's.
   warmup    — the run's first-use work (``compile_warmup``): phase 5's
               sheets in two fresh processes with the kernels built, the
               warm-up off, then on (stage seconds, each image's first
               dispatch ``compile_s`` and wall, the warm-up's seconds,
               every forward on the one device thread, K1 twice per forward
               with the warm-up's counted, the same crowns from both runs
               and as phase 5's); then the package copied without its
               build directory and imported from the copy, over the 16-tile
               neighbour alone, off then on (a cold build: the first
               image's ``compile_s`` and the predict stage's seconds).
6. pipeline_two_model — ``process_files`` in its two-model configuration
               (``urban_model``, ``forrest_model``, a forest outline over the
               west half of the sheet) with ``TD_ROI_FLAT=0`` on the same
               synthetic 1 km^2 sheet: checks both prediction roots, the
               tiles each pass skipped, the fused layer, K5's launch count
               (K1's is 0), and that a second call predicts nothing; then
               one Predictor pass over the 16-tile raster of phase 3 under
               ``TD_ROI_RESIDENT=1`` (K6), which must write that phase's
               flat pass's tile files byte for byte.
   bench     — the bench (``treedetection_tpu_torch/bench.py``) in this
               process with ``BENCH_DETAIL=1``: its line (every key, rates
               finite and positive, 400 pipeline tiles, crowns, the card),
               its five ``bench-detail`` stages, and K1's launches against
               the count its code implies (twice per forward of the model
               part and per batch of the two pipeline passes); then K1
               against its plain version at the bench's own shapes (R101,
               bf16, batch 8: box pool N=4096 R=7, mask pool N=800 R=14 on
               the detections and on proposals); then a pipelined pass
               beside the same forwards run serially, on the host clock
               and under torch.profiler (the device's busy ms and idle
               share); then ``treedetection-torch bench`` without the
               pipeline part.
7. train     — the port's trainer at example/train_full.py's width: a
               synthetic RGBI raster with crown discs and their polygons as
               a GPKG, cut into 1024^2 uint8 shards (50 m tiles, 20 m
               buffer, max_gt 48) and split 0.15; R50 from scratch (batch
               norm, bf16, remat, batch 4, 1000/512 proposals, preset
               scratch, freeze 0) for 30 steps with one validation, then the
               same with remat off (the first loss equal; peak GiB of
               each); the example checkpoint fine-tuned 10 steps on one
               batch (preset update: the loss falls, stem and res2-res3
               bit-unchanged, the heads changed); one fp32 step at 256^2 on
               the card held against the same step on the CPU; the
               from-scratch weights folded, saved and served by the
               Predictor over phase 3's raster (K1 twice per batch).
   train_sharded — ``make_sharded_train_step`` and ``train_model(mesh=
               group)``: two processes on the one card (torchrun's
               environment, gloo, both on cuda:0; no multi-GPU speed is
               measured): 3 fp32 steps at 256^2 (batch norm, remat, no
               TF32, deterministic algorithms) at a global batch of 2 held
               against one process at batch 2 (every loss term at step 1,
               the RPN terms at every step, each tensor's update, the
               running statistics; the one-process step run twice for its
               own spread); 10 steps at
               phase 7's width at a global batch of 4 (2 per rank) with one
               validation (s/step and peak GiB per rank, the loss falls);
               the ranks' state dicts equal bit for bit after both; rank
               0's checkpoint, which must be that state, folded and served
               over phase 3's raster (K1 twice per batch).
8. eval      — the crowns that phases 3 and 7 served (the shipped and the
               30-step checkpoint, K1 twice per batch) stitched into GPKGs
               and scored against the phase-3 raster's own disc polygons
               with evaluate_gpkg_pair, confidence_sweep and evaluate_grid
               (P, R, F1, mean IoU, best confidence, seconds per call; no
               quality claim); the eval subcommand must print the call's
               metrics.
9. autolabel — a synthetic 1 km^2 nDSM at 1 m (Gaussian crowns, roof
               plateaus): Voronoi and region-grow labels on the card with
               TF32 at torch's defaults and on the CPU (equal seeds, smooth
               heights within 1e-6 of the peak, equal crown layers); the
               seed search timed on a 25 km^2 block, card against CPU; the
               Cambridge flow on the phase-3 raster and its discs; the NDVI
               debug raster against float64 numpy; mask pasting and
               class-aware NMS card against CPU; the voronoi and autolabel
               subcommands against the calls.
10. trace    — ``tools/trace_check.py --parts syncs,off`` under the three
               pooler layouts, in a child process: every sync that a served
               R101 batch of the benchmark's ``r101_tile_stream`` cell makes
               on the device thread lies in a ``sync.<site>`` span and the
               batch record counts each; tracing off enters no
               ``record_function``, makes no CUDA event beyond the arrival
               events, no sync that tracing on does not count, and records
               nothing.  The benchmark's ``syncs_per_batch`` and
               ``sync_wait_ms`` read those spans.  Then the same on the
               ``vitdet_l_tile_stream`` cell (the flat layout): a served
               ViTDet-L batch launches the attention kernel 20 times for
               the windowed blocks and 4 times for the global ones, and no
               sync of the device thread lies inside a ``vit.*`` span.
11. kernels  — the per-kernel summary line, then the card's name and power
               limit, then the final status line.

Imports nothing of JAX.  Exits non-zero without a result when CUDA is not
available or the port's package is not beside this script.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
NPZ = REPO / "example" / "data" / "model_full.npz"
H100_BYTES_PER_S = 3.35e12          # HBM3, SXM data sheet
PEAK_FLOPS = {"float32": 67e12,     # CUDA cores, no tensor cores
              "bfloat16": 989e12}   # dense tensor cores
PHASES = ("build", "kernel", "predictor", "model", "pipeline",
          "pipeline_multihost", "warmup", "pipeline_two_model", "bench",
          "train", "train_sharded", "eval", "autolabel", "trace")
ROI_LIBRARIES = ("roi_pool_flat", "roi_pool_levels", "roi_pool_resident",
                 "roi_pool_prep")
K6_CHUNKS = (1, 2, 4, 8, 16, 32)   # boxes per block timed in the kernel phase
PAIRWISE_BLOCK_ROWS, PAIRWISE_COLS = 8192, 32768   # one production row block
# float32 operations per (row, column) pair that the function needs, counted
# from the arithmetic: every pair 4 (the comparisons that decide whether its
# boxes overlap on both axes; where they do not, the intersection is 0 and so
# is the quotient, with no arithmetic); a pair whose intersection is not 0
# that intersection, 10 (2 min, 2 max, 2 sub, 2 clamp, 1 mul, and the test
# inter != 0), and the rest of its formula, IoU 5 (add, sub, compare,
# divide, compare) and containment 3 (compare, divide, compare); dedupe's
# area term 7 (sub, abs, 2 max, divide, compare, and) where its IoU test
# passes.  All at the float32 peak of PEAK_FLOPS.
PAIR_OPS_EVERY = 4
PAIR_OPS_MEETING = {"iou": 15, "containment": 13, "dedupe": 15}
PAIR_OPS_AREA_TERM = 7
PAIR_KERNELS = {   # mode -> (kernel number, wrapper, the TPU kernel's line)
    "dedupe": ("K2", "pairwise_dedupe_bits", 64),
    "containment": ("K3", "pairwise_containment_bits", 57),
    "iou": ("K4", "pairwise_iou_mask", 49)}
MASK_WRAPPERS = {"dedupe": "pairwise_dedupe_mask",
                 "containment": "pairwise_containment_mask"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    """The card's name and power limit, as the bench reports them."""
    from treedetection_tpu_torch.bench import gpu_line as bench_gpu_line
    return bench_gpu_line()


LAYOUT_ENV = {"flat": {}, "levels": {"TD_ROI_FLAT": "0"},
              "resident": {"TD_ROI_RESIDENT": "1"}}


def _clear_layout_env() -> None:
    for name in ("TD_ROI_FLAT", "TD_ROI_RESIDENT", "TD_ROI_SMALL",
                 "TD_ROI_LARGE_FRAC", "TD_ROI_EXACT_FRAC"):
        os.environ.pop(name, None)


class layout_env:
    """Set the pooler-layout variables of one layout for the block, and
    restore what was there before."""

    def __init__(self, layout: str):
        self.values = LAYOUT_ENV[layout]

    def __enter__(self):
        self.saved = {k: os.environ.get(k)
                      for k in ("TD_ROI_FLAT", "TD_ROI_RESIDENT")}
        for k in self.saved:
            os.environ.pop(k, None)
        os.environ.update(self.values)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def _launches(*names, reset=False):
    """The launches of the counters ``names`` (``build.launch_counts``);
    with ``reset``, every counter starts again from 0."""
    from treedetection_tpu_torch.build import launch_counts
    counts = launch_counts(reset)
    return {name: counts[name] for name in names}


ROI = ("k1", "k5", "k6")
PAIRWISE = ("iou", "containment", "dedupe", "pairs")


# --- phase 1: build ----------------------------------------------------------

def phase_build(state):
    from treedetection_tpu_torch import build, native  # noqa: F401
    from treedetection_tpu_torch.ops.kernels import (  # noqa: F401
        pairwise, relpos_attention, roi_align)
    results, errors = {}, {}

    def run(name, fn):
        t0 = time.time()
        try:
            results[name] = (fn(), time.time() - t0)
        except Exception as exc:  # reported below; the phase fails
            errors[name] = repr(exc)

    t0 = time.time()
    jobs = [(name, lib.build) for name, lib in build.LIBRARIES.items()]
    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        fail(f"build: {errors}")
    ptxas = {}
    for name in ROI_LIBRARIES + ("pairwise_boxes", "relpos_attention"):
        log = results[name][0].with_suffix(".log")
        ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                       if "registers" in ln or "spill" in ln or "smem" in ln]
    # the bf16 kernels of K1, K5 and K6, all pool_box_bf16: registers,
    # spills, static shared memory (ptxas) and the dynamic shared memory a
    # block asks for (from the built library)
    levels = build.load(roi_align.LEVELS)
    dynamic = {f"R{r}": levels.td_roi_pool_bf16_smem_bytes(r) for r in (7, 14)}
    bf16_ptxas = {}
    for key, lib, kernel in (
            ("k1", "roi_pool_flat", "roi_pool_flat_bf16_kernel"),
            ("k5", "roi_pool_levels", "roi_pool_levels_bf16_kernel"),
            ("k6", "roi_pool_resident", "roi_pool_resident_bf16_kernel")):
        report = ptxas_report(
            results[lib][0].with_suffix(".log").read_text(), kernel)
        for res, row in report.items():
            row["dynamic_smem_bytes"] = dynamic.get(res)
        bf16_ptxas[key] = report
    relation = relation_ptxas(
        results["pairwise_boxes"][0].with_suffix(".log").read_text())
    emit({"phase": "build", "seconds": round(time.time() - t0, 3),
          "each_s": {k: round(v[1], 3) for k, v in results.items()},
          "ptxas": ptxas, "bf16_kernels": bf16_ptxas,
          "relation_kernels": relation})
    state["bf16_ptxas"] = bf16_ptxas
    state["relation_ptxas"] = relation
    state["relpos_ptxas"] = ptxas["relpos_attention"]
    import re
    spills = [int(n) for ln in ptxas["relpos_attention"]
              for n in re.findall(r"(\d+) bytes spill", ln)]
    if not spills or any(spills):
        fail(f"build: the attention kernel spills: "
             f"{ptxas['relpos_attention']}")
    if sorted(relation) != sorted(RELATION_FORMS):
        fail(f"build: relation_kernel instances {sorted(relation)}, "
             f"expected {sorted(RELATION_FORMS)}")
    for key, report in bf16_ptxas.items():
        if sorted(report) != ["R14", "R7"] or any(
                v["spill_stores"] or v["spill_loads"] or v["registers"] > 128
                or not v["dynamic_smem_bytes"] for v in report.values()):
            fail(f"build: {key.upper()}'s bf16 kernel: {report} (expected "
                 f"R=7 and R=14, no spills, at most 128 registers)")


def _ptxas_entries(log: str):
    """``-Xptxas -v`` lines -> [(entry function, {registers, spill_stores,
    spill_loads, static_smem_bytes})] in the log's order."""
    import re
    out = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            out.append((m.group(1), {"registers": None, "spill_stores": None,
                                     "spill_loads": None,
                                     "static_smem_bytes": 0}))
            continue
        if not out:
            continue
        row = out[-1][1]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            row["spill_stores"] = int(m.group(1))
            row["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            row["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            row["static_smem_bytes"] = int(m.group(1))
    return out


# relation_kernel<MODE, FORM> instances that the pairwise library holds
RELATION_FORMS = ("iou/uint8", "containment/uint8", "containment/bits",
                  "dedupe/uint8", "dedupe/bits")


def relation_ptxas(log: str):
    """The relation kernel's instances in the pairwise library's ``-Xptxas
    -v`` lines -> {"iou/uint8": {registers, spill_stores, ...}, ...}."""
    import re
    modes, forms = ("iou", "containment", "dedupe"), ("uint8", "bits")
    out = {}
    for name, row in _ptxas_entries(log):
        m = re.search(r"relation_kernelILi(\d)ELi(\d)E", name)
        if m:
            out[f"{modes[int(m.group(1))]}/{forms[int(m.group(2))]}"] = row
    return out


def ptxas_report(log: str, kernel: str):
    """``-Xptxas -v`` lines of one kernel template -> {"R7": {registers,
    spill_stores, spill_loads, static_smem_bytes}, ...} by its resolution
    (``ILi7E``)."""
    import re
    out = {}
    for name, row in _ptxas_entries(log):
        r = re.search(r"ILi(\d+)E", name)
        if kernel in name and r:
            out[f"R{r.group(1)}"] = row
    return out


# --- phase 2: kernel at production shapes -----------------------------------

def _timed_ms(fn, warmup=3, iters=20):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_ms(fn, kernel: str, iters=20):
    """Device time per call of ``fn`` (a wrapper that launches one CUDA
    kernel whose name holds ``kernel`` per call), from torch.profiler over
    ``iters`` calls after one warm-up: the kernel alone, without the
    wrapper's host work.  None ("not measured") unless the profiler
    recorded all ``iters`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    seen = [e for e in prof.key_averages() if kernel in e.key]
    if sum(e.count for e in seen) != iters:
        return None
    total = sum(getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0)) for e in seen)
    return total / 1e3 / iters if total else None


def _back_to_back_ms(launch, iters=20):
    """Device time per call of ``launch`` (the wrappers' own launchers into
    buffers allocated once: no checks, no allocation, no synchronisation):
    CUDA events around ``iters`` calls queued back to back after 3
    warm-ups."""
    import torch
    for _ in range(3):
        launch()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        launch()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def _synthetic_boxes(rng, b, n, img=1024.0):
    """Crown-like boxes: 16-200 px, aspect up to 2, a few elongated."""
    c = rng.uniform(0, img, (b, n, 2))
    s = rng.uniform(16, 200, (b, n, 1))
    asp = rng.uniform(0.5, 2.0, (b, n, 1))
    wh = s * [1.0, 1.0] * (asp ** [0.5, -0.5])
    out = np.concatenate([c - wh / 2, c + wh / 2], axis=-1)
    return np.clip(out, 0, img).astype(np.float32)


def _touched_cells(shape2d, rows, cols, spans):
    """Number of (row, column) cells of one buffer inside the union of the
    boxes' hat spans (``hat_spans``) placed at their window origins (rows,
    cols): the cells that carry weight.  A 2-D difference array summed
    along both axes counts the rectangles' union."""
    import torch
    h, w = int(shape2d[0]), int(shape2d[1])
    live = spans[:, 1] >= spans[:, 0]
    rows, cols, spans = rows.long()[live], cols.long()[live], spans[live]
    r0 = (rows + spans[:, 0]).clamp(0, h)
    r1 = (rows + spans[:, 1] + 1).clamp(0, h)
    c0 = (cols + spans[:, 2]).clamp(0, w)
    c1 = (cols + spans[:, 3] + 1).clamp(0, w)
    diff = torch.zeros((h + 1, w + 1), dtype=torch.int32, device=rows.device)
    for rr, cc, sign in ((r0, c0, 1), (r0, c1, -1), (r1, c0, -1),
                         (r1, c1, 1)):
        diff.index_put_((rr, cc), torch.full_like(rr, sign, dtype=torch.int32),
                        accumulate=True)
    cover = diff.cumsum(0).cumsum(1)[:h, :w]
    return int((cover > 0).sum())


def pool_bound(feature_bytes, n, c, item, ay, ax, resolution, dtype_name,
               index_bytes, spans):
    """Least time the card could take for one pooling call: the larger of
    the bytes the function must move (``feature_bytes`` of the feature
    buffers, the index and hat inputs, the output) over HBM bandwidth and
    its FLOPs over the peak for the type.  The FLOPs are the two
    contractions over each box's hat span (``spans``, from ``hat_spans``):
    2 C (R Y X + R R X) for a Y x X span, nothing for an empty one."""
    ny = (spans[:, 1] - spans[:, 0] + 1).clamp(min=0).double()
    nx = (spans[:, 3] - spans[:, 2] + 1).clamp(min=0).double()
    nbytes = (feature_bytes + index_bytes * n
              + 4 * (ay.numel() + ax.numel())
              + n * resolution * resolution * c * item)
    flops = 2 * c * float((resolution * ny * nx
                           + resolution * resolution * nx).sum())
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def k1_bound(inputs, resolution, dtype_name):
    """K1: the cells of fcat inside the boxes' hat spans, 8 index bytes per
    box."""
    from treedetection_tpu_torch.ops.kernels.roi_align import hat_spans
    p = inputs
    c, item = p.kcat.shape[-1], p.kcat.element_size()
    spans = hat_spans(p.ay, p.ax)
    cells = _touched_cells(p.kcat.shape[:2], p.rows, p.cols, spans)
    return pool_bound(cells * c * item, p.rows.shape[0], c, item, p.ay, p.ax,
                      resolution, dtype_name, 8, spans)


def _level_cells(kpadded, meta, spans):
    """Cells of the level buffers inside the hat spans, ``meta`` (N, 3)
    [level, absolute row, column]."""
    cells = 0
    for level, buf in enumerate(kpadded):
        sel = meta[:, 0] == level
        cells += _touched_cells(buf.shape[:2], meta[sel, 1], meta[sel, 2],
                                spans[sel])
    return cells


def k5_bound(inputs, resolution, dtype_name):
    """K5: the cells of each level buffer inside the hat spans (K1's less
    the width padding), 12 index bytes per box."""
    from treedetection_tpu_torch.ops.kernels.roi_align import hat_spans
    p = inputs
    c, item = p.kpadded[0].shape[-1], p.kpadded[0].element_size()
    spans = hat_spans(p.ay, p.ax)
    cells = _level_cells(p.kpadded, p.meta.long(), spans)
    return pool_bound(cells * c * item, p.meta.shape[0], c, item, p.ay, p.ax,
                      resolution, dtype_name, 12, spans)


def k6_bound(inputs, resolution, dtype_name):
    """K6: as K5, on the clamped windows' image-absolute rows with their
    refolded hats (a padding box has zero hats: no cell, no operation), the
    hats once, 12 index bytes per box, the output (the padding boxes' rows
    are inputs and outputs too).  Reading the hats again for every C-block
    is the kernel's design, not the function's need."""
    import torch
    from treedetection_tpu_torch.ops.kernels.roi_align import hat_spans
    r = inputs
    c, item = r.kpadded[0].shape[-1], r.kpadded[0].element_size()
    n, dev = r.meta.shape[0], r.meta.device
    src_hs = torch.tensor([k.shape[0] // r.n_images for k in r.kpadded],
                          device=dev)
    meta = r.meta.long()
    image = torch.arange(n, device=dev) // (n // r.n_images)
    absolute = torch.stack([meta[:, 0], image * src_hs[meta[:, 0]] + meta[:, 1],
                            meta[:, 2]], dim=1)
    spans = hat_spans(r.ay, r.ax)
    cells = _level_cells(r.kpadded, absolute, spans)
    return pool_bound(cells * c * item, n, c, item, r.ay, r.ax, resolution,
                      dtype_name, 12, spans)


def tolerance(ref, dtype_name):
    """-> (atol, rtol) for ``|got - ref| <= atol + rtol * |ref|``.

    float32: the two versions sum the same terms in different orders, about
    1e-6 of the output's peak, so atol 2e-5 of the peak.  bfloat16: both
    round the hats and t to bf16, accumulate both contractions in float32 in
    different orders and round the output once.  The output's own rounding
    may differ by one bf16 ulp (rtol 2^-7).  Where the order flips the
    rounding of a t element (about one in 6e6 on the CPU, float32 against
    float64 sums), the output moves by A_x[j, x] ulp(t) <= 2^-7 A_x |t|
    before its own rounding: atol 2^-8 of the output's peak."""
    peak = max(1.0, float(ref.float().abs().max())) if ref.numel() else 1.0
    if dtype_name == "float32":
        return 2e-5 * peak, 0.0
    return 2.0 ** -8 * peak, 2.0 ** -7


def check_close(got, ref, dtype_name):
    """-> (ok, max_abs_err, stated tolerance)"""
    atol, rtol = tolerance(ref, dtype_name)
    diff = (got.float() - ref.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    return ok, err, {"atol": atol, "rtol": rtol}


def ulp_errors(got, ref):
    """bfloat16 errors in units of the reference's bf16 ulp where the
    reference is not 0: the largest, and how many outputs are off by more
    than one ulp."""
    import torch
    r = ref.float()
    d = (got.float() - r).abs()
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(1e-30))) - 7)
    units = torch.where(r != 0, d / ulp, 0.0)
    return {"max_err_ulps": float(units.max()) if units.numel() else 0.0,
            "n_beyond_one_ulp": int((units > 1).sum()),
            "n_outputs": units.numel()}


def _cut_padding(out, r):
    """Drop the padding boxes at the end of each image's list."""
    if not r.pad_per:
        return out
    per = out.shape[0] // r.n_images
    return out.reshape((r.n_images, per) + out.shape[1:])[
        :, :per - r.pad_per].reshape((-1,) + out.shape[1:])


def phase_kernel(state):
    import torch
    from treedetection_tpu_torch.ops.kernels import roi_align as k
    from treedetection_tpu_torch.ops.roi_align import (
        PATCH, flat_pool_inputs, level_pool_inputs, resident_c_split,
        resident_pool_inputs)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    b, c = 10, 256
    feats32 = [torch.from_numpy(rng.standard_normal(
        (b, 1024 // s, 1024 // s, c)).astype(np.float32)).to(dev)
        for s in (4, 8, 16, 32)]
    summary = state.setdefault("roi", {})
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        feats = [f.to(dtype) for f in feats32]
        for pool, n, r in (("box", 512, 7), ("mask", 100, 14)):
            boxes = torch.from_numpy(_synthetic_boxes(rng, b, n)).to(dev)
            flat = flat_pool_inputs(feats, boxes, r, (4, 8, 16, 32))
            lvl = level_pool_inputs(feats, boxes, r, (4, 8, 16, 32))
            res = {cs: resident_pool_inputs(lvl, r, 2, b, c_split=cs)
                   for cs in (1, 2)}
            picked = resident_c_split(lvl.kpadded, b)
            # kernel -> (wrapper, plain version, arguments, bound, shapes)
            calls = {"k1": (k.roi_pool_patches_flat,
                            k.roi_pool_patches_flat_reference,
                            (flat.kcat, flat.rows, flat.cols, flat.ay,
                             flat.ax, r), k1_bound(flat, r, dname),
                            {"fcat_shape": list(flat.kcat.shape)}),
                     "k5": (k.roi_pool_patches, k.roi_pool_patches_reference,
                            (lvl.kpadded, lvl.meta, lvl.ay, lvl.ax, r),
                            k5_bound(lvl, r, dname),
                            {"buffer_shapes": [list(f.shape[:2])
                                               for f in lvl.kpadded]})}
            for cs, ri in res.items():
                calls[f"k6_c{cs}"] = (
                    k.roi_pool_resident, k.roi_pool_resident_reference,
                    (ri.kpadded, ri.meta, ri.ay, ri.ax, r, PATCH, ri.chunk,
                     b, cs), k6_bound(ri, r, dname),
                    {"chunk": ri.chunk, "pad_per_image": ri.pad_per,
                     "n_padded": int(ri.meta.shape[0]), "c_split": cs,
                     "c_split_the_launcher_picks": picked})
            k1_out = None
            for name, (fn, plain, args, bound, shapes) in calls.items():
                got = fn(*args)
                ref = plain(*args)
                torch.cuda.synchronize()
                ok, err, tol = check_close(got, ref, dname)
                if not ok or not torch.isfinite(got.float()).all():
                    fail(f"kernel {name} {pool} {dname}: max abs err {err} "
                         f"vs {tol}")
                row = {"phase": "kernel", "kernel": name, "pool": pool,
                       "dtype": dname, "n": b * n, "resolution": r, **shapes,
                       "max_abs_err": err, "tolerance": tol}
                if dtype == torch.bfloat16:
                    row["vs_plain"] = ulp_errors(got, ref)
                if name == "k1":
                    k1_out = got
                else:   # the same boxes through another layout: K1, K5
                    # and K6 share pool_box in float32 and pool_box_bf16 in
                    # bfloat16, so they must be bit-equal
                    mine = _cut_padding(got, res[int(name[-1])]) \
                        if name.startswith("k6") else got
                    _, err_k1, _ = check_close(mine, k1_out, dname)
                    row["max_abs_err_vs_k1"] = err_k1
                    if dtype == torch.bfloat16:
                        row["vs_k1"] = ulp_errors(mine, k1_out)
                    if err_k1 != 0.0:
                        fail(f"kernel {name} {pool} {dname}: differs from K1 "
                             f"on the same boxes by {err_k1} (expected 0.0)")
                del got, ref
                row["ms"] = _timed_ms(lambda: fn(*args))
                row["plain_ms"] = _timed_ms(lambda: plain(*args), 1, 3)
                row.update(bound)
                emit(row)
                summary.setdefault(name, {})[(pool, dname)] = row
            # K6 by the boxes one block serves, at the C-split the launcher
            # picks: what the pooler's chunk constants rest on (the
            # kernel's device time: CUDA events also take in the wrapper's
            # host work, the same at every chunk); every chunk must give
            # K1's bits
            k6_kernel = ("roi_pool_resident_bf16_kernel"
                         if dtype == torch.bfloat16
                         else "roi_pool_resident_kernel")
            by_chunk, device_by_chunk = {}, {}
            for chunk in K6_CHUNKS:
                ri = resident_pool_inputs(lvl, r, 2, b, chunk=chunk,
                                          c_split=picked)
                args = (ri.kpadded, ri.meta, ri.ay, ri.ax, r, PATCH,
                        ri.chunk, b, picked)
                got = _cut_padding(k.roi_pool_resident(*args), ri)
                _, err, _ = check_close(got, k1_out, dname)
                if err != 0.0:
                    fail(f"kernel k6 {pool} {dname} chunk {chunk}: differs "
                         f"from K1 on the same boxes by {err} (expected 0.0)")
                del got
                by_chunk[chunk] = _timed_ms(
                    lambda: k.roi_pool_resident(*args))
                device_by_chunk[chunk] = _device_ms(
                    lambda: k.roi_pool_resident(*args), k6_kernel)
                del ri, args
            emit({"phase": "kernel", "kernel": "k6_by_chunk",
                  "pool": pool, "dtype": dname, "c_split": picked,
                  "ms_by_chunk": by_chunk,
                  "device_ms_by_chunk": device_by_chunk,
                  "chunk_of_the_pooler": res[1].chunk,
                  "k1_ms": summary["k1"][(pool, dname)]["ms"],
                  "k5_ms": summary["k5"][(pool, dname)]["ms"]})
            summary.setdefault("k6_by_chunk", {})[(pool, dname)] = {
                "ms": by_chunk, "device_ms": device_by_chunk}
            if dtype == torch.bfloat16:
                # K1, K5 and K6 (at the C-split the launcher picks), all on
                # pool_box_bf16, timed in turns on the same boxes (K1, K5,
                # K6, K6, K5, K1): CUDA events around each call (the
                # wrapper's host work included), then the profiler's device
                # time of the kernel alone
                runs = {
                    "k1": (lambda: k.roi_pool_patches_flat(*calls["k1"][2]),
                           "roi_pool_flat_bf16_kernel"),
                    "k5": (lambda: k.roi_pool_patches(*calls["k5"][2]),
                           "roi_pool_levels_bf16_kernel"),
                    "k6": (lambda: k.roi_pool_resident(
                        *calls[f"k6_c{picked}"][2]),
                        "roi_pool_resident_bf16_kernel")}
                order = ("k1", "k5", "k6", "k6", "k5", "k1")
                turns = {key: [] for key in runs}
                dev_turns = {key: [] for key in runs}
                for key in order:
                    turns[key].append(_timed_ms(runs[key][0]))
                for key in order:
                    dev_turns[key].append(_device_ms(*runs[key]))
                line = {"phase": "kernel", "kernel": "k1_k5_k6_in_turns",
                        "pool": pool, "dtype": dname, "order": order,
                        "k6_c_split": picked,
                        "k6_chunk": res[picked].chunk}
                for key in runs:
                    name = f"k6_c{picked}" if key == "k6" else key
                    line[f"{key}_ms_turns"] = turns[key]
                    line[f"{key}_device_ms_turns"] = dev_turns[key]
                    line[f"{key}_bound_ms"] = \
                        summary[name][(pool, dname)]["bound_ms"]
                line["ptxas"] = state.get("bf16_ptxas")
                emit(line)
            del k1_out, flat, lvl, res, calls
            torch.cuda.empty_cache()


# --- phase 2a: the batched pooler's geometry and exact-tail kernels ----------

GEOMETRY_FIELDS = ("img", "levels", "oy", "ox_al", "sy", "sx_al", "valid_y",
                   "valid_x", "ay", "ax", "overflow", "prio")


# --- ViTDet's attention kernel -----------------------------------------------

# the vitdet_l_tile_stream cell's shapes: batch 10, 1024^2 input -> 64 x 64
# tokens, 16 heads of 64, windows of 14 (20 blocks) or the whole map (4)
RELPOS_SHAPES = {"batch": 10, "side": 64, "heads": 16, "window": 14,
                 "blocks": {"window": 20, "global": 4}}
# the kernel's edges beside the cell's shapes: (name, batch, H, W, heads,
# window (0: global), one table per head) -- per-head tables, a map that is
# no multiple of the window, a global width that fills no 64-token tile row,
# batch 1
RELPOS_EDGES = (
    ("window_tables_per_head", 2, 64, 64, 16, 14, True),
    ("global_tables_per_head", 1, 64, 64, 16, 0, True),
    ("window_map_40x56", 2, 40, 56, 16, 14, False),
    ("global_map_40x56", 1, 40, 56, 16, 0, False),
    ("window_batch_1", 1, 64, 64, 16, 14, False),
)


def relpos_bound_ms(b, side, heads, sh, sw):
    """The least time of one launch: the larger of its operations (every
    real query against its window's Sh * Sw keys for q.k and p.v, and the
    Sh + Sw table rows) over the bf16 peak and its bytes (q, k, v and the
    output of the map, the bias, both tables) over the memory's, as the
    benchmark's ``flops_vitdet.attention_work`` counts them."""
    n, c = side * side, heads * 64
    ops = 2 * b * n * c * (2 * sh * sw + sh + sw)
    nbytes = 2 * (b * n * 4 * c + 3 * c + (2 * sh - 1 + 2 * sw - 1) * 64)
    t_ops = ops / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _relpos_library(qkv, bias, rh, rw, heads, window):
    """The yardstick: ``F.scaled_dot_product_attention`` over the windows,
    the decomposed bias materialised as its mask (bf16)."""
    import torch
    import torch.nn.functional as F
    from treedetection_tpu_torch.ops.kernels.relpos_attention import rel_index
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    s = window or h
    hp = -(-h // s) * s
    x = qkv
    if hp != h:
        x = bias.expand(b, hp, hp, c3).clone()
        x[:, :h, :w] = qkv
    nw = hp // s
    x = x.reshape(b, nw, s, nw, s, 3, heads, 64).permute(
        5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b * nw * nw, heads, s * s, 64)
    q, k, v = x[0], x[1], x[2]
    idx = rel_index(s, qkv.device)
    qq = q.reshape(-1, heads, s, s, 64)
    bh = torch.einsum("nhyxd,ykd->nhyxk", qq, rh[idx])
    bw = torch.einsum("nhyxd,xkd->nhyxk", qq, rw[idx])
    mask = (bh[..., :, None] + bw[..., None, :]).reshape(
        -1, heads, s * s, s * s)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def _relpos_inputs(gen, b, h, w, heads, window, per_head):
    """bf16 qkv, bias and tables of std 1.7 (q, k) and 0.1 (tables): logits
    scale*q.k of std ~3, the bias terms of std ~1.4, as the cell's
    calibrated weights give them."""
    import torch
    c = heads * 64
    sh, sw = (window, window) if window else (h, w)
    lead = (heads,) if per_head else ()
    qkv = (torch.randn(b, h, w, 3 * c, generator=gen, device="cuda")
           * 1.7).bfloat16()
    bias = (torch.randn(3 * c, generator=gen, device="cuda") * 1.7).bfloat16()
    rh = (torch.randn(*lead, 2 * sh - 1, 64, generator=gen, device="cuda")
          * 0.1).bfloat16()
    rw = (torch.randn(*lead, 2 * sw - 1, 64, generator=gen, device="cuda")
          * 0.1).bfloat16()
    return qkv, bias, rh, rw


def phase_kernel_relpos(state):
    """The attention kernel at the ViTDet cell's shapes against its plain
    version, with its times, bound and launches; then on the kernel's edge
    shapes (``RELPOS_EDGES``) against the plain version."""
    import torch
    from treedetection_tpu_torch.ops.kernels import relpos_attention as ra
    attention = ("relpos.window", "relpos.global")
    sh = RELPOS_SHAPES
    b, side, heads = sh["batch"], sh["side"], sh["heads"]
    gen = torch.Generator(device="cuda").manual_seed(20)
    rows = {}
    for kind, window in (("window", sh["window"]), ("global", 0)):
        s = window or side
        qkv, bias, rh, rw = _relpos_inputs(gen, b, side, side, heads, window,
                                           False)
        _launches(reset=True)
        got = ra.relpos_attention(qkv, bias, rh, rw, heads, window)
        torch.cuda.synchronize()
        launched = tuple(_launches(*attention).values())
        # the plain version in float32 on the same bf16 inputs; the global
        # block's materialised logits on two images of the batch
        m = b if window else 2
        plain = ra.relpos_attention_reference(
            qkv[:m].float(), bias.float(), rh.float(), rw.float(), heads,
            window)
        err = (got[:m].float() - plain).abs()
        scale = float(plain.abs().max())
        card_ms = _timed_ms(lambda: ra.relpos_attention(
            qkv, bias, rh, rw, heads, window))
        alone_ms = _device_ms(lambda: ra.relpos_attention(
            qkv, bias, rh, rw, heads, window), "relpos_attention_kernel")
        plain_ms = _timed_ms(lambda: ra.relpos_attention_reference(
            qkv[:m], bias, rh, rw, heads, window), warmup=1, iters=3)
        try:
            library_ms = _timed_ms(lambda: _relpos_library(
                qkv, bias, rh, rw, heads, window), warmup=1, iters=5)
        except RuntimeError as exc:     # out of memory: not measured
            library_ms = None
            emit({"phase": "kernel", "kernel": "relpos_attention",
                  "kind": kind, "library_error": repr(exc)[:300]})
        torch.cuda.empty_cache()
        bound_ms, bound_by = relpos_bound_ms(b, side, heads, s, s)
        rows[kind] = {
            "shape": [b, side, side, heads, 64], "window": window,
            "launched": launched, "max_abs_err": float(err.max()),
            "mean_abs_err": float(err.mean()), "out_abs_max": scale,
            "finite": bool(torch.isfinite(got).all()),
            "ms": card_ms, "alone_ms": alone_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "plain_ms": plain_ms, "plain_images": m,
            "library_ms": library_ms, "blocks_per_forward":
            sh["blocks"][kind]}
        emit({"phase": "kernel", "kernel": "relpos_attention", "kind": kind,
              "error_reason": "bf16 q, k, v and tables; p rounded to bf16 "
                              "before p.v; the output rounded to bf16 once; "
                              "against the plain version in float32 on the "
                              "same inputs",
              **rows[kind]})
        del qkv, got, plain
        torch.cuda.empty_cache()
    edges = {}
    for name, eb, eh, ew, eheads, window, per_head in RELPOS_EDGES:
        qkv, bias, rh, rw = _relpos_inputs(gen, eb, eh, ew, eheads, window,
                                           per_head)
        _launches(reset=True)
        got = ra.relpos_attention(qkv, bias, rh, rw, eheads, window)
        torch.cuda.synchronize()
        launched = tuple(_launches(*attention).values())
        plain = ra.relpos_attention_reference(
            qkv.float(), bias.float(), rh.float(), rw.float(), eheads, window)
        err = (got.float() - plain).abs()
        edges[name] = {
            "shape": [eb, eh, ew, eheads, 64], "window": window,
            "tables_per_head": per_head, "launched": launched,
            "max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
            "out_abs_max": float(plain.abs().max()),
            "finite": bool(torch.isfinite(got).all())}
        emit({"phase": "kernel", "kernel": "relpos_attention", "edge": name,
              **edges[name]})
        del qkv, got, plain, err
        torch.cuda.empty_cache()
    state["relpos"] = rows
    state["relpos_edges"] = edges
    for kind, r in list(rows.items()) + list(edges.items()):
        want = (1, 0) if r["window"] else (0, 1)
        if r["launched"] != want:
            fail(f"kernel: relpos_attention {kind}: launches {r['launched']},"
                 f" expected {want}")
        # bf16 p and output: a few bf16 ulps of the output's largest value
        if not r["finite"] or r["max_abs_err"] > 0.01 * r["out_abs_max"]:
            fail(f"kernel: relpos_attention {kind}: {r}")


def _geometry_box_sets(rng):
    """name -> (B, N, 4) float32 boxes for the geometry kernel's check."""
    b, n = 10, 512
    phase = _synthetic_boxes(rng, b, n)
    huge = _huge_boxes(phase.reshape(-1, 4), None)[0].reshape(b, n, 4)
    sides, squares, near = [], [], []
    for k in range(-4, 4):          # sqrt(area) = 224 * 2^k, one ulp off
        side = np.float32(224.0 * 2.0 ** k)
        for v in (np.nextafter(side, np.float32(0)), side,
                  np.nextafter(side, np.float32(np.inf))):
            sides.append([0.0, 0.0, v, v])
            near.append([0.0, 0.0, side, v])
        squares.append([0.0, 0.0, 2 * side, side / 2])   # area exactly side^2
        squares.append([100.0, 40.0, 100.0 + side, 40.0 + side])
    edges = []
    for x, y, w, h in ((30, 30, 0, 40), (30, 30, 40, 0), (5, 5, 0, 0),
                       (1024, 1024, 0, 0), (-60, -60, 120, 90),
                       (980, 990, 200, 150), (-500, 400, 2100, 30),
                       (400, -700, 25, 2500), (-2000, -2000, 5000, 5000),
                       (1023.5, 0, 1.0, 1024)):
        edges.append([x, y, x + w, y + h])
    special = np.asarray(sides + near + squares + edges, dtype=np.float32)
    return {"phase": phase, "huge": huge.astype(np.float32),
            "adversarial": _adversarial_boxes()[0][None],
            "special": special[None]}


def geometry_mismatches(mine, index, plain, plain_index):
    """Per output field, the number of elements whose bits differ."""
    import torch
    out = {}
    for name in GEOMETRY_FIELDS + ("index",):
        a = index if name == "index" else getattr(mine, name)
        b = plain_index if name == "index" else getattr(plain, name)
        if a.dtype != b.dtype or a.shape != b.shape:
            out[name] = f"{a.dtype} {tuple(a.shape)} vs {b.dtype} " \
                        f"{tuple(b.shape)}"
            continue
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        out[name] = int((a != b).sum())
    return out


def _launches_per_call(fn):
    """Kernels, copies and fills that one call of ``fn`` puts on the card
    (torch.profiler), after a warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def phase_kernel_prep(state):
    """The geometry kernel bit for bit against ``_box_geometry`` and
    ``_window_index`` run on the card; the exact-tail kernel against
    ``_exact_tail_reference`` within the pooler's tolerance; timings, and
    one batched pooling call's host time and launches."""
    import torch
    from treedetection_tpu_torch.ops import roi_align as ra
    from treedetection_tpu_torch.ops.nms import stable_topk
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(7)
    strides = (4, 8, 16, 32)
    hs = [1024 // s for s in strides]
    for name, boxes_np in _geometry_box_sets(rng).items():
        boxes = torch.from_numpy(boxes_np).to(dev)
        b, n = boxes.shape[:2]
        table = ra.level_table(hs, hs, strides, b, dev)
        img = torch.arange(b, device=dev).repeat_interleave(n)
        for r in (7, 14):
            plain = ra._box_geometry(boxes.reshape(-1, 4), img, table, r, 2)
            for flat in (True, False):
                mine, index = ra.box_geometry(boxes, table, r, 2, flat)
                bad = geometry_mismatches(mine, index, plain,
                                          ra._window_index(plain, flat))
                torch.cuda.synchronize()
                emit({"phase": "kernel", "kernel": "roi_geometry",
                      "boxes": name, "n": b * n, "resolution": r,
                      "layout": "flat" if flat else "levels",
                      "mismatches": bad,
                      "levels_seen": sorted(set(
                          plain.levels.tolist())),
                      "overflowing": int(plain.overflow.sum())})
                if any(v != 0 for v in bad.values()):
                    fail(f"kernel roi_geometry {name} R={r}: mismatches "
                         f"{bad} (expected 0 in every field)")

    b, c = 10, 256
    feats32 = [torch.from_numpy(rng.standard_normal(
        (b, 1024 // s, 1024 // s, c)).astype(np.float32)).to(dev)
        for s in strides]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        feats = [f.to(dtype) for f in feats32]
        for pool, n, r in (("box", 512, 7), ("mask", 100, 14)):
            boxes = torch.from_numpy(_synthetic_boxes(rng, b, n)).to(dev)
            for layout, prep in (("flat", ra.flat_pool_inputs),
                                 ("levels", ra.level_pool_inputs)):
                p = prep(feats, boxes, r, strides)
                flat = layout == "flat"
                buffers = (p.kcat,) if flat else p.kpadded
                g = p.geom
                m = int(np.ceil(n * (0.05 if r <= 8 else 0.08)))
                idx = torch.stack([torch.randperm(n, device=dev)[:m]
                                   for _ in range(b)])
                flag = torch.from_numpy(rng.choice(
                    [0.0, 2.0], (b, m)).astype(np.float32)).to(dev)
                every = (torch.ones(n, device=dev).expand(b, n),
                         torch.arange(n, device=dev).expand(b, n))
                for picked, (fl, ix) in (("mixed", (flag, idx)),
                                         ("every_box", every)):
                    start = torch.randn((b * n, r, r, c), device=dev).to(dtype)
                    got, ref = start.clone(), start.clone()
                    sel_got = torch.zeros(b * n, dtype=torch.bool, device=dev)
                    sel_ref = sel_got.clone()
                    _launches(reset=True)
                    ra.exact_tail(buffers, flat, g, fl, ix, got, sel_got, r,
                                  2)
                    ra._exact_tail_reference(buffers, flat, g, fl, ix, ref,
                                             sel_ref, r, 2)
                    torch.cuda.synchronize()
                    ok, err, tol = check_close(got, ref, dname)
                    untouched = ~sel_ref
                    same_rest = bool(torch.equal(got[untouched],
                                                 start[untouched]))
                    same_sel = bool(torch.equal(sel_got, sel_ref))
                    row = {"phase": "kernel", "kernel": "roi_exact_tail",
                           "pool": pool, "dtype": dname, "layout": layout,
                           "picked": picked, "taken": int(sel_ref.sum()),
                           "max_abs_err": err, "tolerance": tol,
                           "untouched_rows_equal": same_rest,
                           "sel_equal": same_sel,
                           "launches": _launches("exact_tail")[
                               "exact_tail"]}
                    if dtype == torch.bfloat16:
                        row["vs_plain"] = ulp_errors(got, ref)
                    if picked == "mixed" and flat:
                        row["ms"] = _timed_ms(lambda: ra.exact_tail(
                            buffers, flat, g, fl, ix, got, None, r, 2))
                        row["device_ms"] = _device_ms(
                            lambda: ra.exact_tail(buffers, flat, g, fl, ix,
                                                  got, None, r, 2),
                            "exact_tail_kernel")
                        row["plain_ms"] = _timed_ms(
                            lambda: ra._exact_tail_reference(
                                buffers, flat, g, fl, ix, ref, None, r, 2),
                            1, 3)
                    emit(row)
                    if not (ok and same_rest and same_sel
                            and row["launches"] == 1):
                        fail(f"kernel roi_exact_tail {pool} {dname} "
                             f"{layout} {picked}: {row}")
                    del got, ref, start
                if flat:
                    table = g.table
                    geom = {"phase": "kernel", "kernel": "roi_geometry",
                            "pool": pool, "dtype": dname, "n": b * n,
                            "resolution": r}
                    _launches(reset=True)
                    ra.box_geometry(boxes, table, r, 2, True)
                    geom["launches"] = _launches("geometry")["geometry"]
                    geom["ms"] = _timed_ms(
                        lambda: ra.box_geometry(boxes, table, r, 2, True))
                    geom["device_ms"] = _device_ms(
                        lambda: ra.box_geometry(boxes, table, r, 2, True),
                        "box_geometry_kernel")
                    img = torch.arange(b, device=dev).repeat_interleave(n)
                    geom["plain_ms"] = _timed_ms(lambda: ra._window_index(
                        ra._box_geometry(boxes.reshape(-1, 4), img, table,
                                         r, 2), True), 1, 3)
                    emit(geom)
                    if geom["launches"] != 1:
                        fail(f"kernel roi_geometry: {geom}")
                del p, buffers, g
            if dtype == torch.bfloat16:
                # one pooling call of the default layout: the host's time to
                # enqueue it (no sync at steady state) and what it launches
                def call():
                    return ra.multilevel_roi_align_batched(feats, boxes, r,
                                                           strides)
                call()
                torch.cuda.synchronize()
                host = []
                for _ in range(20):
                    t0 = time.perf_counter()
                    call()
                    host.append((time.perf_counter() - t0) * 1e3)
                    torch.cuda.synchronize()
                emit({"phase": "kernel", "kernel": "pooling_call",
                      "pool": pool, "dtype": dname, "n": b * n,
                      "resolution": r,
                      "host_ms_median": statistics.median(host),
                      "host_ms_min": min(host),
                      "launches": _launches_per_call(call),
                      "ms": _timed_ms(call)})
        del feats
        torch.cuda.empty_cache()


# --- phase 2b: K2/K3/K4 against their plain versions, exactly ----------------

def _crown_boxes(rng, n):
    """n crown boxes of 2-35 m span scattered so that a few neighbours
    overlap each, and polygon areas within +-50% of the box area."""
    extent = 8.0 * math.sqrt(n)
    c = rng.uniform(0, extent, (n, 2))
    wh = rng.uniform(2, 35, (n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], axis=1).astype(np.float32)
    areas = (wh[:, 0] * wh[:, 1] * rng.uniform(0.5, 1.5, n)).astype(np.float32)
    return boxes, areas


def _adversarial_boxes():
    """Identical boxes, zero-area boxes, a box exactly inside another (ratio
    1.0), ratio and IoU exactly 0.9, polygon areas equal (rel = 0) and zero
    (the 1e-9 floor)."""
    boxes = np.array([
        [0, 0, 10, 10], [0, 0, 10, 10], [5, 5, 5, 5], [3, 3, 3, 9],
        [2, 2, 6, 6], [0, 0, 10, 9], [1, 0, 10, 10], [20, 20, 30, 30],
        [20, 20, 30, 30], [100, 100, 101, 101]], dtype=np.float32)
    areas = np.array([50, 50, 0, 0, 16, 90, 90, 0, 0, 1], dtype=np.float32)
    return boxes, areas


def _huge_boxes(boxes, areas):
    """The boxes with every 37th reaching past 2^126 in magnitude (finite):
    the relation kernel's warps that hold one take the whole formula."""
    boxes = boxes.copy()
    boxes[::37, 0], boxes[::37, 2] = -3e38, 3e38
    return boxes, areas


def pair_work(mode, rows, cols, t0):
    """What one (rows, cols) relation needs beyond the four comparisons of
    every pair, from this run's boxes: (pairs whose intersection is not 0,
    pairs whose IoU test passes; the second for dedupe only).  Counted by the
    script with PyTorch on the card, 1024 rows at a time."""
    import torch
    from treedetection_tpu_torch.ops.boxes import box_iou_matrix
    meeting = iou_hits = 0
    cb = cols[:, :4]
    for s in range(0, rows.shape[0], 1024):
        rb = rows[s:s + 1024, :4]
        lt = torch.maximum(rb[:, None, :2], cb[None, :, :2])
        br = torch.minimum(rb[:, None, 2:], cb[None, :, 2:])
        wh = torch.clamp(br - lt, min=0)
        meeting += int(((wh[..., 0] * wh[..., 1]) != 0).sum())
        if mode == "dedupe":
            iou_hits += int((box_iou_matrix(rb, cb) > t0).sum())
    return meeting, iou_hits


def pair_bound(mode, r, n, meeting, iou_hits, form):
    """Least time the card could take for an (r, n) relation: the bytes it
    must move (both box arrays read once, the relation written once: r *
    ceil(n/8) bytes bit-packed, r * n as a uint8 mask) over HBM bandwidth, or
    the float32 operations it needs (``PAIR_OPS_*``: four comparisons for
    every pair, the intersection and the rest only where the boxes meet)
    over the CUDA-core peak."""
    width = 5 if mode == "dedupe" else 4
    out_bytes = r * ((n + 7) // 8) if form == "bits" else r * n
    nbytes = 4 * width * (r + n) + out_bytes
    ops = (PAIR_OPS_EVERY * r * n + PAIR_OPS_MEETING[mode] * meeting
           + PAIR_OPS_AREA_TERM * iou_hits)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS["float32"] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": ops}


def pairs_bound(r, n, p):
    """relation_pairs' least time: the packed block read once, the (2, p)
    int32 pairs written once (a popcount per word is far below the bytes)."""
    nbytes = r * ((n + 7) // 8) + 8 * p
    return {"bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes}


def _pair_calls(pw, mode, b, a, rows, thr):
    """-> {"uint8": (kernel call, plain call), "bits": (...)} for one mode
    (no "bits" for iou); ``rows`` is None (square) or a (start, stop) slice
    of the boxes."""
    import torch
    rb = None if rows is None else b[rows[0]:rows[1]].contiguous()
    ra = None if rows is None else a[rows[0]:rows[1]].contiguous()
    if mode == "iou":
        return {"uint8": (
            lambda: pw.pairwise_iou_mask(b, thr[0], rows=rb),
            lambda: pw.iou_mask_reference(b if rb is None else rb, b,
                                          thr[0]))}
    if mode == "containment":
        def plain():
            out = pw.containment_mask_reference(b if rb is None else rb, b,
                                                thr[0])
            return out.fill_diagonal_(0) if rb is None else out
        mask = lambda: pw.pairwise_containment_mask(b, thr[0], rows=rb)
        bits = lambda: pw.pairwise_containment_bits(b, thr[0], rows=rb)
    else:
        b5 = torch.cat([b, a[:, None]], dim=1)
        a5 = b5 if rb is None else torch.cat([rb, ra[:, None]], dim=1)
        plain = lambda: pw.dedupe_mask_reference(a5, b5, thr[0], thr[1])
        mask = lambda: pw.pairwise_dedupe_mask(b, a, thr[0], thr[1], rows=rb,
                                               row_areas=ra)
        bits = lambda: pw.pairwise_dedupe_bits(b, a, thr[0], thr[1], rows=rb,
                                               row_areas=ra)
    return {"uint8": (mask, plain),
            "bits": (bits, lambda: pw.pack_bits_rows(plain()))}


def _host_pairs(mask, row_offset):
    """np.nonzero of a uint8 mask on the host, rows shifted, the diagonal
    left out: the crown filter's per-block host work before this port's
    compaction kernel."""
    ii, jj = np.nonzero(mask)
    ii = ii + row_offset
    keep = ii != jj
    return ii[keep], jj[keep]


def _old_block_path(pw, mask_call, row_offset):
    """A row block as the crown filter streamed it before: the uint8 mask,
    packed to bits on the card, copied to the host, unpacked, nonzero, the
    diagonal dropped."""
    m = mask_call()
    packed = pw.pack_bits_rows(m).cpu().numpy()
    return _host_pairs(np.unpackbits(packed, axis=1, count=m.shape[1]),
                       row_offset)


def _new_block_path(pw, bits_call, n_cols, row_offset):
    """A row block as the crown filter streams it now: the bit-packed
    relation, compacted on the card, only the pairs copied to the host."""
    pairs = pw.relation_pairs(bits_call(), n_cols, row_offset, True)
    pairs = pairs.cpu().numpy().astype(np.int64)
    return pairs[0], pairs[1]


def phase_kernel_pairwise(state):
    import torch
    from treedetection_tpu_torch.ops.kernels import pairwise as pw
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    big = _crown_boxes(rng, PAIRWISE_COLS)
    small = _crown_boxes(rng, 1000)
    # a column count that is a multiple of 16 but not of a block's 2048:
    # the uint8 form's 16-byte stores up to a block's last full chunk
    mid = _crown_boxes(np.random.default_rng(2), 1008)
    adv = _adversarial_boxes()
    groups = (   # name, (boxes, areas), rows, thresholds per mode, timed
        ("production_block", big, (0, PAIRWISE_BLOCK_ROWS), None, True),
        ("ragged_77x1000", small, (400, 477), None, False),
        ("square_1000", small, None, None, False),
        ("ragged_130x1008", mid, (500, 630), None, False),
        ("adversarial_t1.0", adv, None,
         {"iou": (0.5, 0), "containment": (1.0, 0), "dedupe": (0.5, 1e-6)},
         False),
        ("adversarial_t0.9", adv, (2, 9),
         {"iou": (0.9, 0), "containment": (0.9, 0), "dedupe": (0.9, 0.5)},
         False),
        # every pair that does not meet is a hit: pins the kernel's
        # zero-intersection branch
        ("thresholds_le_0", small, None,
         {"iou": (-0.1, 0), "containment": (0.0, 0), "dedupe": (-0.1, 0.3)},
         False),
        # boxes past 2^126: their warps take the whole formula
        ("huge_coordinates", _huge_boxes(*small), (300, 700), None, False))
    default_thr = {"iou": (0.5, 0), "containment": (0.9, 0),
                   "dedupe": (0.5, 0.3)}
    summary = state.setdefault("pairwise", {})
    for name, (boxes, areas), rows, thr, timed in groups:
        b = torch.from_numpy(boxes).to(dev)
        a = torch.from_numpy(areas).to(dev)
        start = 0 if rows is None else rows[0]
        for mode in ("dedupe", "containment", "iou"):
            t = (thr or default_thr)[mode]
            calls = _pair_calls(pw, mode, b, a, rows, t)
            mask_k, mask_p = calls["uint8"]
            got, ref = mask_k(), mask_p()
            torch.cuda.synchronize()
            if got.dtype != torch.uint8 or got.shape != ref.shape:
                fail(f"kernel {mode} {name}: {got.dtype} {tuple(got.shape)}")
            r, n = ref.shape
            row = {"phase": "kernel", "kernel": PAIR_KERNELS[mode][0],
                   "mode": mode, "group": name, "thresholds": list(t),
                   "shape": [r, n], "ones": int(ref.sum()),
                   "mismatches": int((got != ref).sum()),
                   "tolerance": "exact equality of the uint8 masks" + (
                       ", of the packed bytes, and of the pair arrays"
                       if "bits" in calls else "")}
            del got
            bits = None
            if "bits" in calls:
                bits_k, bits_p = calls["bits"]
                bits, ref_bits = bits_k(), bits_p()
                torch.cuda.synchronize()
                if bits.shape != ref_bits.shape or bits.dtype != torch.uint8:
                    fail(f"kernel {mode} {name}: bits {bits.dtype} "
                         f"{tuple(bits.shape)}, expected "
                         f"{tuple(ref_bits.shape)}")
                row["bits_mismatches"] = int((bits != ref_bits).sum())
                del ref_bits
                # relation_pairs against np.nonzero of the plain mask
                ii, jj = _host_pairs(ref.cpu().numpy(), start)
                pairs = pw.relation_pairs(bits, n, start, True).cpu().numpy()
                row["pairs"] = len(ii)
                row["pairs_equal"] = bool(
                    pairs.shape == (2, len(ii))
                    and np.array_equal(pairs[0], ii)
                    and np.array_equal(pairs[1], jj))
            if timed:
                row.update(_time_pairwise(pw, mode, calls, b, a, rows, t,
                                          bits, start, (r, n), row["pairs"]
                                          if bits is not None else 0))
                summary[mode] = row
            del ref, bits
            emit(row)
            if row["mismatches"] or row.get("bits_mismatches"):
                fail(f"kernel {mode} {name}: {row['mismatches']} mask entries "
                     f"and {row.get('bits_mismatches')} packed bytes differ "
                     f"from the plain version")
            if row.get("pairs_equal") is False:
                fail(f"kernel {mode} {name}: relation_pairs differs from "
                     f"np.nonzero of the plain mask")
            if row.get("paths_equal") is False:
                fail(f"kernel {mode} {name}: the old and the new per-block "
                     f"paths give other pairs")
            if name != "ragged_77x1000" and row["ones"] == 0:
                fail(f"kernel {mode} {name}: the relation is empty, the "
                     f"comparison is vacuous")
            torch.cuda.empty_cache()


def _relation_launcher(pw, mode, form, b, a, rows, t):
    """The relation kernel through the wrappers' launcher ``_launch_into``
    on the rows (start, stop) of the boxes against all of them, into a
    buffer allocated once."""
    import torch
    rb, ra = b[rows[0]:rows[1]].contiguous(), a[rows[0]:rows[1]].contiguous()
    rws, cols = pw._dedupe_operands(b, a, rb, ra) if mode == "dedupe" \
        else (rb, b)
    n = cols.shape[0]
    width = pw._bits_pitch(n) if form == "bits" else n
    out = torch.empty((rws.shape[0], width), dtype=torch.uint8,
                      device=b.device)
    return lambda: pw._launch_into(mode, rws, cols, out, t[0], t[1],
                                   packed=form == "bits")


def _pairs_launcher(pw, bits, n, start, n_pairs):
    """The compaction of one packed block through relation_pairs' own
    launchers (count, scan, write), without the read-back of the total
    (known here) and the copy to the host."""
    import torch
    counts = torch.empty(bits.shape[0], dtype=torch.int64, device=bits.device)
    ends = torch.empty_like(counts)
    out = torch.empty((2, n_pairs), dtype=torch.int32, device=bits.device)

    def launch():
        pw._pair_ends_into(bits, n, start, True, counts, ends)
        pw._pairs_into(bits, n, start, True, ends, out)
    return launch


def _time_pairwise(pw, mode, calls, b, a, rows, t, bits, start, shape,
                   n_pairs):
    """The production block's times: CUDA events around each wrapper call
    (median of 20 after 3 warm-ups; plain versions and the old per-block
    path 3 after 1), the kernels alone (``kernel_ms``: the wrappers'
    launchers back to back), and the bounds."""
    r, n = shape
    rows = rows or (0, n)
    meeting, iou_hits = pair_work(mode, b[rows[0]:rows[1]], b, t[0])
    mask_k, mask_p = calls["uint8"]
    out = {"meeting_pairs": meeting, "iou_test_hits": iou_hits,
           "uint8": {"ms": _timed_ms(mask_k),
                     "plain_ms": _timed_ms(mask_p, 1, 3),
                     "kernel_ms": _back_to_back_ms(_relation_launcher(
                         pw, mode, "uint8", b, a, rows, t)),
                     **pair_bound(mode, r, n, meeting, iou_hits, "uint8")}}
    if bits is None:
        out.update(out["uint8"])
        return out
    bits_k, bits_p = calls["bits"]
    out.update({"ms": _timed_ms(bits_k), "plain_ms": _timed_ms(bits_p, 1, 3),
                "kernel_ms": _back_to_back_ms(_relation_launcher(
                    pw, mode, "bits", b, a, rows, t)),
                **pair_bound(mode, r, n, meeting, iou_hits, "bits")})
    out["relation_pairs"] = {
        "ms": _timed_ms(lambda: pw.relation_pairs(bits, n, start, True)),
        "plain_ms": _timed_ms(
            lambda: pw.relation_pairs_reference(bits, n, start, True), 1, 3),
        "kernel_ms": _back_to_back_ms(_pairs_launcher(pw, bits, n, start,
                                                      n_pairs)),
        **pairs_bound(r, n, n_pairs)}
    old = lambda: _old_block_path(pw, mask_k, start)
    new = lambda: _new_block_path(pw, bits_k, n, start)
    (oi, oj), (ni, nj) = old(), new()
    out["paths_equal"] = bool(np.array_equal(oi, ni)
                              and np.array_equal(oj, nj))
    out["block_path"] = {"old_ms": _timed_ms(old, 1, 3),
                         "new_ms": _timed_ms(new)}
    return out


# --- phase 3: the Predictor at full width ------------------------------------

def write_synthetic_raster(path: Path, seed: int = 0):
    """1000x1000 px RGBI at 0.2 m: dark crown-like discs of 2-8 m radius on
    a lighter ground, with noise -> the discs as (row, col, radius) px."""
    from treedetection_tpu_torch.geo import Affine, write_geotiff
    rng = np.random.default_rng(seed)
    h = w = 1000
    img = np.empty((h, w, 4), dtype=np.float32)
    img[..., :3] = rng.normal([150, 160, 120], 12, (h, w, 3))
    img[..., 3] = rng.normal(110, 10, (h, w))
    yy, xx = np.mgrid[0:h, 0:w]
    discs = []
    for _ in range(180):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        rad = rng.uniform(2.0, 8.0) / 0.2
        discs.append((cy, cx, rad))
        d2 = ((yy - cy) ** 2 + (xx - cx) ** 2) / rad ** 2
        inside = d2 < 1.0
        shade = 0.55 + 0.3 * d2[inside]
        img[inside, 0] = img[inside, 0] * shade * 0.6
        img[inside, 1] = img[inside, 1] * shade * 0.85
        img[inside, 2] = img[inside, 2] * shade * 0.6
        img[inside, 3] = np.minimum(img[inside, 3] * 1.8, 255)
    write_geotiff(str(path), np.clip(img, 0, 255).astype(np.uint8),
                  Affine.from_origin(412000.0, 5318000.0, 0.2, 0.2),
                  crs=25832)
    return discs


def predictor_config(workdir: Path, **over):
    cfg = {"model_depth": 50, "model_input_size": 1024,
           "rpn_post_nms_topk": 512, "max_detections": 100,
           "pixel_std": [57.375, 57.12, 58.395], "batch_size": 10,
           "mixed_precision": True, "tile_width": 50, "tile_height": 50,
           "buffer": 20, "device": "cuda", "num_workers": 5,
           "use_overlap": False, "output_directory": str(workdir / "out")}
    cfg.update(over)
    return cfg


def phase_predictor(state, workdir: Path):
    import torch
    from treedetection_tpu_torch import prediction
    from treedetection_tpu_torch.preprocessing import tile_single_file
    _clear_layout_env()
    tif = workdir / "rgb" / "324125317.tif"
    tif.parent.mkdir(parents=True)
    state["discs"] = write_synthetic_raster(tif)
    meta = tile_single_file(str(tif), str(workdir / "tiles"), buffer=20,
                            tile_width=50, tile_height=50)
    n_tiles = len(json.loads(Path(meta).read_text()))
    if n_tiles != 16:
        fail(f"predictor: expected 16 tiles, planned {n_tiles}")
    cfg = predictor_config(workdir)
    t0 = time.time()
    pred = prediction.Predictor(cfg, str(NPZ))
    load_s = time.time() - t0
    if pred.used_random_init:
        fail("predictor: checkpoint did not load")
    out1 = workdir / "pred_first"
    t0 = time.time()
    pred(str(tif), meta, str(out1))
    torch.cuda.synchronize()
    first_s = time.time() - t0

    out2 = workdir / "pred_timed"
    torch.cuda.reset_peak_memory_stats()
    _launches(reset=True)               # just before the main path
    t0 = time.time()
    written = pred(str(tif), meta, str(out2))
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = _launches(*ROI)            # just after
    launches = counts["k1"]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    stats = dict(prediction.LAST_RUN_STATS)
    batches = int(stats["batches"])
    files = sorted(out2.glob("Prediction_*.json"))
    crowns = _count_crowns(files, "predictor")
    first = sorted(out1.glob("Prediction_*.json"))
    if [f.name for f in first] != [f.name for f in files]:
        fail("predictor: the two passes wrote different tiles")
    row = {"phase": "predictor", "tiles": written, "batches": batches,
           "tiles_per_s": written / wall, "ms_per_batch": wall / batches * 1e3,
           "wall_s": wall, "first_pass_s": first_s, "load_s": load_s,
           "crowns": crowns, "roi_overflow": int(stats["roi_overflow"]),
           "prop_overflow": int(stats["prop_overflow"]),
           "k1_launches": launches, "peak_device_gib": peak_gib,
           "host_stats_s": {k: stats[k] for k in (
               "dispatch_s", "fetch_s", "flush_s", "wall_s")}}
    emit(row)
    if written != 16 or len(files) != 16:
        fail(f"predictor: wrote {written} tiles, {len(files)} files")
    if crowns == 0:
        fail("predictor: no crowns written on the synthetic raster")
    if launches != 2 * batches or counts["k5"] or counts["k6"]:
        fail(f"predictor: launches {counts} for {batches} batches in the "
             f"default layout (expected K1 twice per batch and no other)")
    state["predictor"] = row
    state["tif"], state["meta"], state["pred"] = tif, meta, pred
    state["pred_timed_dir"] = out2


def _count_crowns(files, phase: str) -> int:
    """Crowns in the Predictor's tile files; fails on a malformed one."""
    crowns = 0
    for f in files:
        for crown in json.loads(f.read_text()):
            ring = np.asarray(crown["polygon_coords"][0], dtype=np.float64)
            if ring.ndim != 2 or ring.shape[1] != 2 or \
                    not np.isfinite(ring).all() or \
                    not 0.0 < crown["score"] <= 1.0:
                fail(f"{phase}: malformed crown in {f.name}")
            crowns += 1
    return crowns


def _tile_files(pred_dir: Path):
    """tile file name -> the Predictor's JSON file, as bytes."""
    return {p.name: p.read_bytes() for p in pred_dir.glob("Prediction_*.json")}


def phase_predictor_levels(state, workdir: Path):
    """The predictor phase's Predictor over the same 16 tiles under
    ``TD_ROI_FLAT=0``: K5 pools in place of K1.  In bfloat16 both run
    pool_box_bf16 on the same cells, so the tile files must equal the
    default pass's byte for byte."""
    import torch
    pred = state["pred"]
    out = workdir / "pred_levels"
    _launches(reset=True)                    # just before the main path
    with layout_env("levels"):
        t0 = time.time()
        n_written = pred(str(state["tif"]), state["meta"], str(out))
        torch.cuda.synchronize()
        wall = time.time() - t0
    counts = _launches(*ROI)                 # just after
    batches = math.ceil(n_written / pred.batch_size)
    flat, mine = _tile_files(state["pred_timed_dir"]), _tile_files(out)
    differ = sorted(name for name in flat if mine.get(name) != flat[name])
    row = {"phase": "predictor_levels", "tiles": n_written,
           "batches": batches, "wall_s": wall, "launches": counts,
           "tile_files": len(mine), "tile_files_of_the_default_pass":
           len(flat), "files_that_differ": differ,
           "crowns": sum(len(json.loads(b)) for b in mine.values()),
           "tolerance": "byte-for-byte equal tile files (K5 and K1 share "
                        "pool_box_bf16)"}
    emit(row)
    if counts != {"k1": 0, "k5": 2 * batches, "k6": 0}:
        fail(f"predictor_levels: ROI launches {counts} for {batches} "
             f"batches under TD_ROI_FLAT=0 (expected K5 twice per batch "
             f"and no other)")
    if sorted(mine) != sorted(flat) or differ:
        fail(f"predictor_levels: the tile files differ from the default "
             f"pass's: {row}")
    state["predictor_levels"] = row


def phase_predictor_split(state, workdir: Path):
    """A Predictor over two device entries on the one card (``devices:
    [cuda:0, cuda:0]``: two model replicas, two streams, each chunk
    dispatched from a thread of its own) over the same 16 tiles: each batch
    of 10 splits into two chunks of 5, and K1 runs twice per chunk.  Held
    byte for byte against a one-device Predictor at batch 5, which runs the
    same forwards on the same tiles: the card has one GPU, so this shows the
    split path equal to the one-device path and says nothing of the speed
    of two cards.  Against the batch-10 pass of the predictor phase the
    tile files are only reported: the library convolutions and matrix
    products may sum in another order at another batch size."""
    import torch
    from treedetection_tpu_torch import prediction
    split = prediction.Predictor(
        predictor_config(workdir, devices=["cuda:0", "cuda:0"]), str(NPZ))
    chunk = prediction.Predictor(
        predictor_config(workdir, batch_size=split.batch_size // 2),
        str(NPZ))
    tif, meta = str(state["tif"]), state["meta"]
    split(tif, meta, str(workdir / "pred_split_warm"))   # warm-up
    chunk_dir = workdir / "pred_chunk"
    chunk(tif, meta, str(chunk_dir))
    out = workdir / "pred_split"
    _launches(reset=True)                    # just before the main path
    t0 = time.time()
    n_written = split(tif, meta, str(out))
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = _launches(*ROI)                 # just after
    batches = math.ceil(n_written / split.batch_size)
    mine, same_chunk = _tile_files(out), _tile_files(chunk_dir)
    batch10 = _tile_files(state["pred_timed_dir"])
    differ = sorted(n for n in same_chunk if mine.get(n) != same_chunk[n])
    row = {"phase": "predictor_split",
           "devices": [str(d) for d in split.devices],
           "batch_size": split.batch_size, "tiles": n_written,
           "batches": batches, "wall_s": wall, "launches": counts,
           "tile_files": len(mine), "files_that_differ": differ,
           "crowns": sum(len(json.loads(b)) for b in mine.values()),
           "tolerance": f"byte-for-byte equal tile files to the one-device "
                        f"Predictor at batch {chunk.batch_size}",
           "files_that_differ_from_the_batch_10_pass": sorted(
               n for n in batch10 if mine.get(n) != batch10[n]),
           "crowns_of_the_batch_10_pass": sum(
               len(json.loads(b)) for b in batch10.values())}
    emit(row)
    if counts != {"k1": 4 * batches, "k5": 0, "k6": 0}:
        fail(f"predictor_split: ROI launches {counts} for {batches} batches "
             f"over two devices (expected K1 twice per chunk, two chunks "
             f"per batch)")
    if sorted(mine) != sorted(same_chunk) or differ:
        fail(f"predictor_split: the tile files differ from the one-device "
             f"pass's at the chunk's batch size: {row}")
    state["predictor_split"] = row


def phase_profile(state, workdir: Path, out_dir: Path):
    """One more Predictor pass under torch.profiler: device time by kernel,
    the device's busy share of the wall time, and a Chrome trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out_dir.mkdir(parents=True, exist_ok=True)
    pred = state["pred"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        pred(str(state["tif"]), state["meta"], str(workdir / "pred_prof"))
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    (out_dir / "kernels.txt").write_text(prof.key_averages().table(
        sort_by="self_cuda_time_total", row_limit=60))
    prof.export_chrome_trace(str(out_dir / "trace.json"))
    # the forward alone, synchronously, batch after batch
    items = pred._load_tiles(state["meta"], None)[:pred.batch_size]
    batch, pad = pred.load_batch(str(state["tif"]), items)
    forward, _ = pred._get_forward(pad)
    fwd_ms = []
    for i in range(6):
        t0 = time.time()
        forward(batch)
        torch.cuda.synchronize()
        if i:
            fwd_ms.append((time.time() - t0) * 1e3)
    emit({"phase": "profile", "forward_ms_median": statistics.median(fwd_ms),
          "wall_ms": wall * 1e3,
          "device_busy_ms": busy_ms, "device_busy_share": busy_ms / 1e3 / wall,
          "top": [{"ms": r[0] / 1e3, "calls": r[1], "name": r[2][:90]}
                  for r in rows[:25]]})


# --- phase 4: the kernel inside the model ------------------------------------

def phase_model(state, workdir: Path):
    import torch
    from treedetection_tpu_torch import prediction
    from treedetection_tpu_torch.models.mask_rcnn import FPN_STRIDES
    from treedetection_tpu_torch.models.rpn import generate_proposals
    from treedetection_tpu_torch.ops.kernels.roi_align import (
        roi_pool_patches_flat, roi_pool_patches_flat_reference)
    from treedetection_tpu_torch.ops.roi_align import flat_pool_inputs
    pred = prediction.Predictor(
        predictor_config(workdir, mixed_precision=False), str(NPZ))
    items = pred._load_tiles(state["meta"], None)[:pred.batch_size]
    batch, pad = pred.load_batch(str(state["tif"]), items)
    model, c = pred.model, pred.model.cfg
    with torch.no_grad():
        x = pred.preprocess(torch.from_numpy(batch).to(pred.device), pad)
        out_k = model(x, roi_pool=roi_pool_patches_flat)
        out_p = model(x, roi_pool=roi_pool_patches_flat_reference)
        feats = model.backbone(x)
        logits, deltas = model.rpn_head(feats)
        props = generate_proposals(
            logits, deltas, model.anchors(x.device), c.input_size,
            c.rpn_pre_nms_topk, c.rpn_post_nms_topk, c.rpn_nms_threshold)
        errs = {}
        for name, boxes, r in (("proposals", props.boxes, c.box_pool),
                               ("detections", out_k.boxes, c.mask_pool)):
            p = flat_pool_inputs(feats[:4], boxes, r, FPN_STRIDES[:4])
            args = (p.kcat, p.rows, p.cols, p.ay, p.ax, r)
            got = roi_pool_patches_flat(*args)
            ref = roi_pool_patches_flat_reference(*args)
            ok, err, tol = check_close(got, ref, "float32")
            if not ok:
                fail(f"model: K1 on real {name}: err {err} vs {tol}")
            errs[name] = {"n": int(p.rows.shape[0]), "max_abs_err": err,
                          "tolerance": tol}
    torch.cuda.synchronize()
    same_valid = torch.equal(out_k.valid, out_p.valid)
    box_err = float((out_k.boxes - out_p.boxes).abs()[out_k.valid].max()) \
        if out_k.valid.any() else 0.0
    score_err = float((out_k.scores - out_p.scores).abs().max())
    mask_err = int((out_k.masks.int() - out_p.masks.int()).abs().max())
    # the same forward with the pooler picked by the environment: the three
    # layouts against the K1 forward above, at the same tolerances
    layouts = {}
    for layout, kernel in (("flat", "k1"), ("levels", "k5"),
                           ("resident", "k6")):
        _launches(reset=True)
        with layout_env(layout), torch.no_grad():
            out_l = model(x)
        torch.cuda.synchronize()
        counts = _launches(*ROI)
        same = torch.equal(out_l.valid, out_k.valid)
        layouts[layout] = {
            "launches": counts, "kept": int(out_l.valid.sum()),
            "same_kept_set": same,
            "max_box_err_px": float((out_l.boxes - out_k.boxes).abs()[
                out_k.valid].max()) if same and out_k.valid.any() else None,
            "max_score_err": float((out_l.scores - out_k.scores).abs().max()),
            "max_mask_err_u8": int((out_l.masks.int()
                                    - out_k.masks.int()).abs().max()),
            "roi_overflow": int(out_l.roi_overflow.sum()),
            "prop_overflow": int(out_l.prop_overflow.sum())}
        if counts != {**{"k1": 0, "k5": 0, "k6": 0}, kernel: 2}:
            fail(f"model: layout {layout} launched {counts}, expected "
                 f"{kernel} twice")
    row = {"phase": "model", "dtype": "float32", "tf32": False,
           "pool_checks": errs, "kept_k1": int(out_k.valid.sum()),
           "kept_plain": int(out_p.valid.sum()), "same_kept_set": same_valid,
           "max_box_err_px": box_err, "max_score_err": score_err,
           "max_mask_err_u8": mask_err, "layouts": layouts}
    emit(row)
    if not same_valid or box_err > 1e-2 or score_err > 1e-4 or mask_err > 2:
        fail("model: K1 and the plain pooler disagree inside the forward")
    for layout, r in layouts.items():
        if not r["same_kept_set"] or r["max_box_err_px"] > 1e-2 or \
                r["max_score_err"] > 1e-4 or r["max_mask_err_u8"] > 2:
            fail(f"model: the {layout} layout disagrees with K1 inside the "
                 f"forward: {r}")
    if int(out_k.valid.sum()) == 0:
        fail("model: no detections in the compared batch")
    state["model"] = row


# --- phase 5: process_files end to end ---------------------------------------

NEIGHBOUR_PX = 1000                           # the adjacent 200 m sheet


def pipeline_config(root: Path):
    """The example configuration's model and tiling keys as a raw dict
    (``prepare_config`` fills the rest with its defaults: use_overlap,
    overlap_postprocess and eager_stitch stay at their defaults)."""
    return {
        "image_directory": str(root / "rgb"),
        "height_data_path": str(root / "nDSM"),
        "combined_model": str(NPZ),
        "output_directory": str(root / "out"),
        "tiles_path": str(root / "tiles"),
        "image_regex": r"(\d+)\.tif", "height_data_regex": r"(\d+)\.tif",
        # seam strips: rgbi {base}_{x1}_{y1}_{x2}_{y2}_{end}.tif, height
        # {base}_{x1y1x2y2}_{end}.tif; the concatenated groups must agree.
        # Postprocessing looks a stitched layer's height raster up by
        # matching the IMAGE's stem against the height regexes, so the
        # height regex is written to accept both spellings.
        "image_merged_regex": r"(\d+)_(\d+)_(\d+)_(\d+)_(\d+)_\d+\.tif",
        "height_data_merged_regex":
            r"(\d+)_(\d+)_?(\d*)_?(\d*)_?(\d*)_\d+\.tif",
        "model_depth": 50, "model_input_size": 1024,
        "rpn_post_nms_topk": 512, "max_detections": 100,
        "pixel_std": [57.375, 57.12, 58.395], "batch_size": 10,
        "mixed_precision": True, "tile_width": 50, "tile_height": 50,
        "buffer": 20, "num_workers": 5, "keep_intermediate": True,
        "ndvi_mean_threshold": 0.1, "ndvi_var_threshold": 0.1}


PROCESSED_PROPERTIES = ("Confidence_score", "poly_id", "Area", "TreeHeight",
                        "Centroid", "Diameter", "is_contained",
                        "num_contained")


def _crown_multiset(gpkg_path):
    """Processed crowns as a sorted list of (rounded ring, properties)."""
    from treedetection_tpu_torch.vector import read_gpkg
    geoms, props, srs = read_gpkg(str(gpkg_path))
    rows = []
    for g, p in zip(geoms, props):
        ring = tuple(map(tuple, np.round(np.asarray(g[0][0]), 4).tolist()))
        rows.append((ring, tuple(
            (k, round(p[k], 4) if isinstance(p[k], float) else p[k])
            for k in PROCESSED_PROPERTIES)))
    return sorted(rows), props, srs


def _check_pair_launches(phase, launches, pair_calls):
    """K2 and K3 launched once per row block of the crown counts in
    ``pair_calls``, and relation_pairs once per block of either."""
    from treedetection_tpu_torch import postprocessing
    expected = {"dedupe": 0, "containment": 0}
    for kind, n, blocks in pair_calls:
        if blocks != math.ceil(n / postprocessing.PAIRWISE_BLOCK):
            fail(f"{phase}: {kind} call on {n} crowns ran {blocks} blocks")
        expected[kind] += blocks
    if launches["dedupe"] != expected["dedupe"] or launches["dedupe"] == 0 \
            or launches["containment"] != expected["containment"] \
            or launches["containment"] == 0 or launches["pairs"] != \
            expected["dedupe"] + expected["containment"]:
        fail(f"{phase}: K2/K3/pairs launches {launches} but the crown "
             f"counts {pair_calls} need {expected} and one compaction per "
             f"block")


def phase_pipeline(state, workdir: Path):
    import torch
    from treedetection_tpu_torch import detection, postprocessing
    from treedetection_tpu_torch.config import Config, prepare_config
    from treedetection_tpu_torch.utils.synthetic import (
        DISCS_PER_KM2, SHEET_ORIGIN, SHEET_PX, write_synthetic_sheet)
    from treedetection_tpu_torch.vector import read_gpkg
    root = workdir / "pipeline"
    t0 = time.time()
    big, small = "324125317", "324135317"
    write_synthetic_sheet(root / "rgb" / f"{big}.tif",
                          root / "nDSM" / f"{big}.tif", SHEET_PX, SHEET_ORIGIN,
                          n_discs=int(DISCS_PER_KM2 * (SHEET_PX / 5000) ** 2),
                          seed=2)
    write_synthetic_sheet(root / "rgb" / f"{small}.tif",
                          root / "nDSM" / f"{small}.tif", NEIGHBOUR_PX,
                          (SHEET_ORIGIN[0] + SHEET_PX * 0.2, SHEET_ORIGIN[1]),
                          n_discs=int(DISCS_PER_KM2 * (NEIGHBOUR_PX / 5000) ** 2),
                          seed=3)
    data_s = time.time() - t0
    state["sheet"] = (root / "rgb" / f"{big}.tif", root / "nDSM" / f"{big}.tif")

    _clear_layout_env()
    os.environ["TD_PAIRS_DEVICE"] = "1"
    Config.reset()
    config, _ = prepare_config(pipeline_config(root), str(root))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    postprocessing.LAST_POSTPROCESS_STATS.clear()
    postprocessing.PAIR_KERNEL_CALLS.clear()
    _launches(reset=True)                   # just before the main path
    t0 = time.time()
    outputs = detection.process_files(config)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _launches(*ROI, *PAIRWISE)     # just after
    pair_calls = list(postprocessing.PAIR_KERNEL_CALLS)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    stages = dict(detection.LAST_STAGE_SECONDS)
    pp_stats = dict(postprocessing.LAST_POSTPROCESS_STATS)

    out = root / "out"
    tiles_planned, tiles_predicted, batches = {}, {}, 0
    for meta in sorted((root / "tiles").glob("*.json")):
        n = len(json.loads(meta.read_text()))
        tiles_planned[meta.stem] = n
        tiles_predicted[meta.stem] = len(list(
            (out / "predictions" / meta.stem).glob("Prediction_*.json")))
        batches += math.ceil(n / config["batch_size"])
    strips = sorted(p.name for p in (root / "rgb" / "merged").glob("*.tif"))
    stitched = {p.stem: len(read_gpkg(str(p))[0])
                for p in sorted((out / "predictions").glob("*.gpkg"))}
    written, crowns = {}, {}
    for p in outputs:
        rows, props, srs = _crown_multiset(p)
        crowns[Path(p).name] = rows
        if srs != 25832:
            fail(f"pipeline: {p} has SRS {srs}")
        for prop in props:
            if set(prop) != set(PROCESSED_PROPERTIES):
                fail(f"pipeline: properties {sorted(prop)} in {p}")
        written[Path(p).name] = len(rows)
    pred = config.get("_predictor_cache", {}).get(str(NPZ))
    warmups = len(pred._warm_pads) if pred else 0
    row = {"phase": "pipeline", "config": "R50-FPN, 1024^2, batch 10, 512 "
           "proposals, bf16, TD_PAIRS_DEVICE=1",
           "sheet_px": [SHEET_PX, NEIGHBOUR_PX], "seam_strips": strips,
           "tiles_planned": tiles_planned, "tiles_predicted": tiles_predicted,
           "batches": batches, "warmup_forwards": warmups,
           "warmup_s": dict(pred._warm_pads) if pred else None,
           "crowns_stitched": stitched,
           "crowns_written": written, "wall_s": wall, "data_s": data_s,
           "tiles_per_s": sum(tiles_predicted.values()) / stages["predict"],
           "stage_s": stages, "postprocess_phase_s": pp_stats,
           "pair_kernel_calls": pair_calls, "launches": launches,
           "peak_device_gib": peak_gib,
           "roi_overflow": pred.total_roi_overflow if pred else None,
           "prop_overflow": pred.total_prop_overflow if pred else None}
    emit(row)
    sheet_tiles = math.ceil(SHEET_PX * 0.2 / config["tile_width"]) ** 2
    if tiles_planned.get(big) != sheet_tiles or \
            tiles_planned != tiles_predicted:
        fail(f"pipeline: planned {tiles_planned}, predicted {tiles_predicted}")
    if len(strips) != 1 or len(tiles_planned) != 3:
        fail(f"pipeline: expected one seam strip and three tiled rasters, "
             f"got {strips} and {sorted(tiles_planned)}")
    if f"processed_{big}.gpkg" not in written or \
            written[f"processed_{big}.gpkg"] == 0:
        fail(f"pipeline: no crowns written for the sheet: {written}")
    if pred is None or pred.used_random_init:
        fail("pipeline: the Predictor was not built from the checkpoint")
    if warmups != 1:
        fail(f"pipeline: {warmups} compile warm-ups (compile_warmup is on "
             f"by default: expected one, at the sheet's pad)")
    if launches["k1"] != 2 * (batches + warmups) or launches["k5"] \
            or launches["k6"]:
        fail(f"pipeline: ROI launches {launches} for {batches} batches and "
             f"{warmups} warm-up forward in the default layout (expected K1 "
             f"twice per forward, no other)")
    _check_pair_launches("pipeline", launches, pair_calls)
    state["pipeline"] = row
    state["pipeline_inputs"] = root
    state["pipeline_sheets"] = (big, small)
    state["pipeline_crowns"] = crowns

    # (1) the host-grid branch on the same stitched layers
    del os.environ["TD_PAIRS_DEVICE"]
    before = _launches(*PAIRWISE)
    images, heights = detection._list_images(config)
    base_alloc = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    postprocessing.LAST_POSTPROCESS_STATS.clear()
    t0 = time.time()
    grid_outputs = postprocessing.process_files_in_directory(
        config, str(out / "predictions"), images, heights,
        out_dir=str(root / "out_hostgrid"))
    torch.cuda.synchronize()
    grid_s = time.time() - t0
    stats_peak_gib = (torch.cuda.max_memory_allocated() - base_alloc) / 2 ** 30
    if _launches(*PAIRWISE) != before:
        fail("pipeline: the host-grid branch launched a pairwise kernel")
    same = {}
    for p in grid_outputs:
        name = Path(p).name
        same[name] = _crown_multiset(p)[0] == _crown_multiset(out / name)[0]
    emit({"phase": "pipeline_hostgrid", "seconds": grid_s,
          "same_crowns": same,
          "stats_peak_device_gib_over_resident": stats_peak_gib,
          "postprocess_phase_s": dict(postprocessing.LAST_POSTPROCESS_STATS)})
    if sorted(same) != sorted(written) or not all(same.values()):
        fail(f"pipeline: device-branch and host-grid crowns differ: {same}")

    # (1b) the device branch again on the same stitched layers, outside the
    # Predictor's overlap: its postprocess seconds compare with the host
    # grid's like for like
    os.environ["TD_PAIRS_DEVICE"] = "1"
    postprocessing.LAST_POSTPROCESS_STATS.clear()
    postprocessing.PAIR_KERNEL_CALLS.clear()
    _launches(reset=True)
    t0 = time.time()
    dev_outputs = postprocessing.process_files_in_directory(
        config, str(out / "predictions"), images, heights,
        out_dir=str(root / "out_devicebranch"))
    torch.cuda.synchronize()
    dev_s = time.time() - t0
    del os.environ["TD_PAIRS_DEVICE"]
    dev_launches = _launches(*PAIRWISE)
    dev_calls = list(postprocessing.PAIR_KERNEL_CALLS)
    dev_same = {Path(p).name: _crown_multiset(p)[0]
                == _crown_multiset(root / "out_hostgrid" / Path(p).name)[0]
                for p in dev_outputs}
    state["pipeline_devicebranch"] = {
        "phase": "pipeline_devicebranch", "seconds": dev_s,
        "hostgrid_seconds": grid_s, "same_crowns_as_hostgrid": dev_same,
        "pair_kernel_calls": dev_calls, "launches": dev_launches,
        "postprocess_phase_s": dict(postprocessing.LAST_POSTPROCESS_STATS)}
    emit(state["pipeline_devicebranch"])
    if sorted(dev_same) != sorted(written) or not all(dev_same.values()):
        fail(f"pipeline: the device branch's second pass and the host grid "
             f"give other crowns: {dev_same}")
    _check_pair_launches("pipeline_devicebranch", dev_launches, dev_calls)

    # (2) a second call on the finished output predicts nothing
    os.environ["TD_PAIRS_DEVICE"] = "1"
    Config.reset()
    config2, _ = prepare_config(pipeline_config(root), str(root))
    _launches(reset=True)
    t0 = time.time()
    outputs2 = detection.process_files(config2)
    resume_s = time.time() - t0
    del os.environ["TD_PAIRS_DEVICE"]
    emit({"phase": "pipeline_resume", "seconds": resume_s,
          "k1_launches": _launches("k1")["k1"],
          "predictor_built": "_predictor_cache" in config2,
          "outputs": [Path(p).name for p in outputs2]})
    if _launches("k1")["k1"] or "_predictor_cache" in config2:
        fail("pipeline: the resumed run predicted again")
    if sorted(outputs2) != sorted(outputs):
        fail("pipeline: the resumed run returned other outputs")
    for handler in list(config2["logger"].handlers):
        config2["logger"].removeHandler(handler)
        handler.close()


# --- phase 5b: process_files as two hosts on the one card -------------------

MULTIHOST_HOSTS = 2
MULTIHOST_CHILD_TIMEOUT_S = 600


def multihost_child(root: Path) -> None:
    """One host of the ``pipeline_multihost`` phase (run as ``chip_smoke.py
    --multihost-child ROOT`` with torchrun's environment): ``process_files``
    on ROOT with ``TD_PAIRS_DEVICE=1``, its launch counts set to 0 just
    before and read just after, then one JSON line of its seconds, totals,
    outputs and counts."""
    import torch
    from treedetection_tpu_torch import detection, postprocessing, recoveries
    from treedetection_tpu_torch.config import prepare_config
    from treedetection_tpu_torch.parallel import mesh
    config, _ = prepare_config(pipeline_config(root), str(root))
    postprocessing.PAIR_KERNEL_CALLS.clear()
    _launches(reset=True)                   # just before the main path
    t0 = time.time()
    outputs = detection.process_files(config)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _launches(*ROI, *PAIRWISE)     # just after
    emit({"phase": "pipeline_multihost_host", "rank": mesh.process_index(),
          "warmup_forwards": sum(len(p._warm_pads) for p in config.get(
              "_predictor_cache", {}).values()),
          "processes": mesh.process_count(),
          "manifest_suffix": recoveries._shard_suffix(), "wall_s": wall,
          "stage_s": dict(detection.LAST_STAGE_SECONDS),
          "barrier_wait_s": dict(detection.LAST_BARRIER_SECONDS),
          "totals": detection.LAST_MULTIHOST_TOTALS,
          "outputs": sorted(Path(p).name for p in outputs),
          "launches": launches,
          "pair_kernel_calls": list(postprocessing.PAIR_KERNEL_CALLS)})


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_ranks(root: Path, entry: str, n: int, timeout_s: float,
                 line_prefix: str, phase: str, one_host: bool, **extra):
    """``n`` processes of this script with ``entry ROOT`` and torchrun's
    environment on 127.0.0.1 (``one_host``: as one host's ``n`` local
    ranks; else as ``n`` hosts of one process each), plus ``extra`` ->
    each rank's last JSON line that starts with ``line_prefix``; fails
    the phase if one fails or outlasts ``timeout_s``.  Every process is
    stopped before it returns."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TREEDETECTION_", "TD_ROI_", "LOCAL_"))}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(n), **extra)
    procs = []
    t0 = time.time()
    for rank in range(n):
        local = {"LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(n)} \
            if one_host else {}
        log = open(root / f"rank_{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), entry,
             str(root)], env=dict(env, RANK=str(rank), **local),
            stdout=log, stderr=subprocess.STDOUT), log))
    rows, failed = [], []
    try:
        for rank, (p, log) in enumerate(procs):
            try:
                rc = p.wait(timeout=max(timeout_s - (time.time() - t0), 1))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            log.close()
            text = Path(log.name).read_text()
            line = next((ln for ln in reversed(text.splitlines())
                         if ln.startswith(line_prefix)), None)
            if rc != 0 or line is None:
                failed.append((rank, rc, text[-4000:]))
            else:
                rows.append(json.loads(line))
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if failed:
        fail(f"{phase}: ranks failed: {failed}")
    return rows


def phase_pipeline_multihost(state, workdir: Path):
    """``process_files`` on a copy of the pipeline phase's sheets as two
    hosts: two processes on the one card, torchrun's environment, gloo
    between them (``parallel.ensure_distributed``), the kernels built by
    the build phase and loaded by both.  The crowns must equal the
    single-host pipeline phase's."""
    src, root = state["pipeline_inputs"], workdir / "multihost"
    for sub in ("rgb", "nDSM"):
        (root / sub).mkdir(parents=True)
        for p in sorted((src / sub).glob("*.tif")):
            os.link(p, root / sub / p.name)
    t0 = time.time()
    rows = _spawn_ranks(root, "--multihost-child", MULTIHOST_HOSTS,
                        MULTIHOST_CHILD_TIMEOUT_S,
                        '{"phase": "pipeline_multihost_host"',
                        "pipeline_multihost", one_host=False,
                        TD_PAIRS_DEVICE="1")
    wall = time.time() - t0
    for row in rows:
        emit(row)
    want = state["pipeline_crowns"]
    got_names = sorted(n for row in rows for n in row["outputs"])
    same = {name: _crown_multiset(root / "out" / name)[0] == rows_
            for name, rows_ in want.items()
            if (root / "out" / name).is_file()}
    launches = {k: sum(row["launches"][k] for row in rows)
                for k in rows[0]["launches"]}
    summary = {"phase": "pipeline_multihost", "hosts": MULTIHOST_HOSTS,
               "wall_s": wall,
               "stage_s_by_host": [row["stage_s"] for row in rows],
               "barrier_wait_s_by_host": [row["barrier_wait_s"]
                                          for row in rows],
               "totals": rows[0]["totals"], "outputs_by_host":
               [row["outputs"] for row in rows], "same_crowns": same,
               "launches": launches,
               "tolerance": "equal crown multisets (rounded rings and "
                            "properties) per processed layer"}
    emit(summary)
    if got_names != sorted(want) or len(same) != len(want) or \
            not all(same.values()):
        fail(f"pipeline_multihost: the two hosts' crowns differ from the "
             f"single-host pipeline phase's: outputs {got_names}, "
             f"expected {sorted(want)}, same {same}")
    ids = [(r["rank"], r["processes"], r["manifest_suffix"]) for r in rows]
    if ids != [(i, MULTIHOST_HOSTS, f".{i}") for i in range(MULTIHOST_HOSTS)]:
        fail(f"pipeline_multihost: ranks and manifest shards {ids}")
    totals = rows[0]["totals"]
    n_crowns = sum(len(v) for v in want.values())
    if any(r["totals"] != totals for r in rows) or \
            [t[0] for t in totals] != [len(r["outputs"]) for r in rows] or \
            sum(t[1] for t in totals) != n_crowns:
        fail(f"pipeline_multihost: all-gathered totals {totals}, expected "
             f"the hosts' output counts and {n_crowns} crowns")
    batches = state["pipeline"]["batches"]
    warmups = [r["warmup_forwards"] for r in rows]
    if warmups != [1] * MULTIHOST_HOSTS:
        fail(f"pipeline_multihost: warm-up forwards by host {warmups} "
             f"(expected one on every host: each starts its own)")
    if launches["k1"] != 2 * (batches + sum(warmups)) or any(
            r["launches"]["k1"] == 0 for r in rows):
        fail(f"pipeline_multihost: K1 launches "
             f"{[r['launches'] for r in rows]} for {batches} batches and "
             f"{sum(warmups)} warm-up forwards (expected twice per forward "
             f"in all, and some on every host)")
    # K2/K3 and relation_pairs once per row block of the crowns each host
    # filtered (a host whose layers hold no crown launches none)
    for row in rows:
        blocks = {kind: sum(b for k, _, b in row["pair_kernel_calls"]
                            if k == kind)
                  for kind in ("dedupe", "containment")}
        got = row["launches"]
        if (got["dedupe"], got["containment"], got["pairs"]) != (
                blocks["dedupe"], blocks["containment"],
                blocks["dedupe"] + blocks["containment"]):
            fail(f"pipeline_multihost host {row['rank']}: K2/K3/pairs "
                 f"launches {got} for the blocks {blocks}")
    _check_pair_launches("pipeline_multihost", launches,
                         [c for row in rows for c in row["pair_kernel_calls"]])
    state["multihost"] = summary


# --- phase 5c: the run's first-use work ---------------------------------------

WARMUP_CHILD_TIMEOUT_S = 300
WARMUP_MODES = ("off", "on")     # compile_warmup false, then true


def warmup_child(root: Path, mode: str) -> None:
    """One ``process_files`` run of the ``warmup`` phase (``chip_smoke.py
    --warmup-child ROOT on|off``) on ROOT with ``compile_warmup`` on or off,
    then one JSON line: the package it imported and whether its build
    directory was missing at the start, the stage seconds, each image's
    first dispatch (``compile_s``) and wall, the warm-up's seconds, the
    thread of every forward and K1's launches."""
    import torch
    import treedetection_tpu_torch
    from treedetection_tpu_torch import build, detection, prediction
    from treedetection_tpu_torch.config import prepare_config
    cold = not build.BUILD_DIR.exists()
    images, threads = [], []
    predict_image = prediction.Predictor._predict_image
    forward_chunk = prediction.Predictor._forward_chunk

    def recorded_image(self, src, items, tifpath, output_dir):
        n = predict_image(self, src, items, tifpath, output_dir)
        stats = prediction.LAST_RUN_STATS
        images.append({"image": Path(tifpath).stem,
                       "tiles": int(stats["tiles"]),
                       "batches": int(stats["batches"]),
                       "compile_s": stats["compile_s"],
                       "wall_s": stats["wall_s"]})
        return n

    def recorded_chunk(self, *args):
        threads.append(threading.current_thread().name)
        return forward_chunk(self, *args)

    prediction.Predictor._predict_image = recorded_image
    prediction.Predictor._forward_chunk = recorded_chunk
    raw = dict(pipeline_config(root), compile_warmup=mode == "on")
    config, _ = prepare_config(raw, str(root))
    _launches(reset=True)                   # just before the main path
    t0 = time.time()
    outputs = detection.process_files(config)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _launches(*ROI)              # just after
    pred = config["_predictor_cache"][str(NPZ)]
    emit({"phase": "warmup_run", "compile_warmup": mode == "on",
          "package": str(Path(treedetection_tpu_torch.__file__).parent),
          "build_dir_missing_at_start": cold, "wall_s": wall,
          "stage_s": dict(detection.LAST_STAGE_SECONDS), "images": images,
          "warmup_s": {str(k): v for k, v in pred._warm_pads.items()},
          "forwards": len(threads), "forward_threads": sorted(set(threads)),
          "launches": launches,
          "outputs": sorted(Path(p).name for p in outputs)})


def _warmup_run(root: Path, mode: str, package_dir=None):
    """``warmup_child`` in a fresh process -> its line.  With
    ``package_dir`` the child imports the package from there (first on
    PYTHONPATH, and ``-P`` keeps this script's directory off the path)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TREEDETECTION_", "TD_", "LOCAL_"))
           and k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")}
    cmd = [sys.executable, str(Path(__file__).resolve()), "--warmup-child",
           str(root), mode]
    if package_dir is not None:
        env["PYTHONPATH"] = os.pathsep.join(
            [str(package_dir)] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        cmd.insert(1, "-P")
    log = root / f"warmup_{mode}.log"
    try:
        with open(log, "w") as fh:
            rc = subprocess.run(cmd, env=env, stdout=fh,
                                stderr=subprocess.STDOUT,
                                timeout=WARMUP_CHILD_TIMEOUT_S).returncode
    except subprocess.TimeoutExpired:
        rc = "timeout"
    text = log.read_text()
    line = next((ln for ln in reversed(text.splitlines())
                 if ln.startswith('{"phase": "warmup_run"')), None)
    if rc != 0 or line is None:
        fail(f"warmup: the {mode} run failed ({rc}): {text[-4000:]}")
    return json.loads(line)


def _sheets_copy(src: Path, root: Path, names) -> None:
    for sub in ("rgb", "nDSM"):
        (root / sub).mkdir(parents=True)
        for name in names:
            os.link(src / sub / f"{name}.tif", root / sub / f"{name}.tif")


def _check_warmup_run(part: str, row, one_device_thread=True) -> None:
    batches = sum(im["batches"] for im in row["images"])
    warmups = len(row["warmup_s"])
    if warmups != (1 if row["compile_warmup"] else 0):
        fail(f"warmup {part}: {warmups} warm-ups with compile_warmup "
             f"{row['compile_warmup']}")
    if row["forwards"] != batches + warmups or \
            row["launches"] != {"k1": 2 * (batches + warmups), "k5": 0,
                                "k6": 0}:
        fail(f"warmup {part}: {row['forwards']} forwards and ROI launches "
             f"{row['launches']} for {batches} batches and {warmups} "
             f"warm-up forwards (expected K1 twice per forward, no other)")
    if one_device_thread and len(row["forward_threads"]) != 1:
        fail(f"warmup {part}: forwards ran on {row['forward_threads']} "
             f"(expected the one device thread for the whole pass)")


def phase_warmup(state, workdir: Path):
    """The run's first-use work.  (1) ``process_files`` over the pipeline
    phase's sheet and neighbour (and the seam strip the tiler cuts) in two
    fresh processes with the kernels already built, ``compile_warmup``
    off, then on: stage seconds, each image's ``compile_s`` and wall, the
    warm-up's seconds, every forward on one device thread (the warm-up's
    included), K1's launches, and the same crowns from both runs (and as
    the pipeline phase's).  (2) A cold build: the package copied without
    its build directory, imported from the copy, over the 16-tile
    neighbour alone, off then on, each from a fresh copy: the first
    image's ``compile_s`` and the predict stage's seconds."""
    import shutil
    src = state["pipeline_inputs"]
    big, small = state["pipeline_sheets"]
    rows = {}
    t0 = time.time()
    for mode in WARMUP_MODES:
        root = workdir / f"warmup_{mode}"
        _sheets_copy(src, root, (big, small))
        rows[mode] = _warmup_run(root, mode)
        emit(dict(rows[mode], phase=f"warmup_{mode}"))
        _check_warmup_run(mode, rows[mode])
    crowns = {mode: {name: _crown_multiset(
        workdir / f"warmup_{mode}" / "out" / name)[0]
        for name in rows[mode]["outputs"]} for mode in WARMUP_MODES}
    same = {name: rows_ == crowns["on"].get(name)
            for name, rows_ in crowns["off"].items()}
    same_as_pipeline = {name: rows_ == state["pipeline_crowns"].get(name)
                        for name, rows_ in crowns["on"].items()}
    warm_s = time.time() - t0

    cold = {}
    t0 = time.time()
    for mode in WARMUP_MODES:
        root = workdir / f"warmup_cold_{mode}"
        package = workdir / f"package_{mode}"
        shutil.copytree(REPO / "treedetection_tpu_torch",
                        package / "treedetection_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        _sheets_copy(src, root, (small,))
        row = _warmup_run(root, mode, package_dir=package)
        emit(dict(row, phase=f"warmup_cold_{mode}"))
        if not row["build_dir_missing_at_start"] or \
                row["package"] != str(package / "treedetection_tpu_torch"):
            fail(f"warmup: the cold {mode} run imported {row['package']} "
                 f"(build directory missing at its start: "
                 f"{row['build_dir_missing_at_start']}), not the copy")
        _check_warmup_run(f"cold {mode}", row)
        cold[mode] = row
    cold_s = time.time() - t0

    summary = {
        "phase": "warmup", "seconds": warm_s + cold_s,
        "warm_build": {mode: {
            "stage_s": rows[mode]["stage_s"],
            "compile_s": {im["image"]: im["compile_s"]
                          for im in rows[mode]["images"]},
            "image_wall_s": {im["image"]: im["wall_s"]
                             for im in rows[mode]["images"]},
            "warmup_s": rows[mode]["warmup_s"],
            "forward_threads": rows[mode]["forward_threads"]}
            for mode in WARMUP_MODES},
        "cold_build": {mode: {
            "first_compile_s": cold[mode]["images"][0]["compile_s"],
            "predict_s": cold[mode]["stage_s"]["predict"],
            "preprocess_s": cold[mode]["stage_s"]["preprocess"],
            "warmup_s": cold[mode]["warmup_s"]} for mode in WARMUP_MODES},
        "same_crowns": same, "same_crowns_as_pipeline": same_as_pipeline,
        "tolerance": "equal crown multisets (rounded rings and properties) "
                     "per processed layer"}
    emit(summary)
    if sorted(same) != sorted(state["pipeline_crowns"]) or \
            not all(same.values()) or not all(same_as_pipeline.values()):
        fail(f"warmup: the runs with the warm-up off and on, or the "
             f"pipeline phase, wrote other crowns: {same}, "
             f"{same_as_pipeline}")
    state["warmup"] = summary


# --- phase 6: the two-model configuration, and the resident layout ----------

def _predicted_tiles(pred_dir: Path):
    return {p.name[len("Prediction_"):-len(".json")]
            for p in pred_dir.glob("Prediction_*.json")}


def phase_pipeline_two_model(state, workdir: Path):
    import shutil

    import torch
    from treedetection_tpu_torch import detection
    from treedetection_tpu_torch.config import Config, prepare_config
    from treedetection_tpu_torch.utils.synthetic import (
        DISCS_PER_KM2, SHEET_ORIGIN, SHEET_PX, write_synthetic_sheet)
    from treedetection_tpu_torch.vector import read_gpkg
    from treedetection_tpu_torch.vector.geojson import write_geojson
    root = workdir / "two_model"
    big = "324125317"
    rgb, ndsm = root / "rgb" / f"{big}.tif", root / "nDSM" / f"{big}.tif"
    t0 = time.time()
    if "sheet" in state:          # the sheet the pipeline phase wrote
        for src, dst in zip(state["sheet"], (rgb, ndsm)):
            dst.parent.mkdir(parents=True, exist_ok=True)
            os.link(src, dst)
    else:
        write_synthetic_sheet(rgb, ndsm, SHEET_PX, SHEET_ORIGIN,
                              n_discs=int(DISCS_PER_KM2 * (SHEET_PX / 5000) ** 2),
                              seed=2)
    # the forest outline: the west half of the sheet, with margins beyond it
    side = SHEET_PX * 0.2
    x0, y1 = SHEET_ORIGIN
    seam = x0 + side / 2
    write_geojson(str(root / "forest.geojson"),
                  [np.array([[x0 - 100, y1 - side - 100], [seam, y1 - side - 100],
                             [seam, y1 + 100], [x0 - 100, y1 + 100]])],
                  [{}], crs_epsg=25832)
    # two copies of the checkpoint, so that two Predictors stay on the card
    for name in ("urban", "forest"):
        shutil.copyfile(NPZ, root / f"{name}.npz")
    data_s = time.time() - t0

    def make_config():
        raw = pipeline_config(root)
        del raw["combined_model"]
        raw.update(urban_model=str(root / "urban.npz"),
                   forrest_model=str(root / "forest.npz"),
                   forrest_outline=str(root / "forest.geojson"))
        Config.reset()
        return prepare_config(raw, str(root))[0]

    _clear_layout_env()
    config = make_config()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    _launches(reset=True)                    # just before the main path
    with layout_env("levels"):
        t0 = time.time()
        outputs = detection.process_files(config)
        torch.cuda.synchronize()
        wall = time.time() - t0
    launches = _launches(*ROI)               # just after
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    stages = dict(detection.LAST_STAGE_SECONDS)

    out = root / "out"
    plan = json.loads((root / "tiles" / f"{big}.json").read_text())
    only_forest = {t for t, m in plan.items() if m["only_forest"]}
    only_urban = {t for t, m in plan.items() if m["only_urban"]}
    passes, batches = {}, 0
    for model, skipped in (("urban", only_forest), ("forest", only_urban)):
        model_root = out / "predictions" / model
        if not (model_root / f"{big}.gpkg").is_file():
            fail(f"pipeline_two_model: no stitched layer under {model_root}")
        got = _predicted_tiles(model_root / big)
        if got != set(plan) - skipped:
            fail(f"pipeline_two_model: the {model} pass predicted "
                 f"{len(got)} tiles, {len(got & skipped)} of them flagged to "
                 f"be skipped; the plan asks for {len(set(plan) - skipped)}")
        n_batches = math.ceil(len(got) / config["batch_size"])
        batches += n_batches
        passes[model] = {
            "tiles_predicted": len(got), "tiles_skipped": len(skipped),
            "batches": n_batches,
            "crowns_stitched": len(read_gpkg(
                str(model_root / f"{big}.gpkg"))[0])}
    fused_path = out / "predictions" / f"{big}.gpkg"
    geoms = read_gpkg(str(fused_path))[0] if fused_path.is_file() else []
    xs = np.array([np.asarray(g[0][0])[:, 0].mean() for g in geoms])
    written = {Path(p).name: len(read_gpkg(str(p))[0]) for p in outputs}
    cache = config.get("_predictor_cache", {})
    warmups = {Path(k).stem: len(p._warm_pads) for k, p in cache.items()}
    row = {"phase": "pipeline_two_model", "config": "R50-FPN, 1024^2, batch "
           "10, 512 proposals, bf16, urban + forest model, TD_ROI_FLAT=0",
           "warmup_forwards": warmups,
           "sheet_px": SHEET_PX, "tiles_planned": len(plan),
           "tiles_only_forest": len(only_forest),
           "tiles_only_urban": len(only_urban), "passes": passes,
           "batches": batches, "crowns_fused": len(geoms),
           "crowns_fused_west": int((xs < seam).sum()),
           "crowns_fused_east": int((xs > seam).sum()),
           "crowns_written": written, "wall_s": wall, "data_s": data_s,
           "tiles_per_s": sum(p["tiles_predicted"] for p in passes.values())
           / stages["predict"], "stage_s": stages, "launches": launches,
           "predictors_resident": len(cache),
           "device_gib_before": base_gib, "peak_device_gib": peak_gib,
           "roi_overflow": sum(p.total_roi_overflow for p in cache.values()),
           "prop_overflow": sum(p.total_prop_overflow
                                for p in cache.values())}
    emit(row)
    if len(plan) != math.ceil(side / config["tile_width"]) ** 2 or \
            not only_forest or not only_urban:
        fail(f"pipeline_two_model: {len(plan)} tiles planned, "
             f"{len(only_forest)} forest-only, {len(only_urban)} urban-only")
    if len(cache) != 2 or len({id(p) for p in cache.values()}) != 2 or \
            any(p.used_random_init for p in cache.values()):
        fail("pipeline_two_model: expected two Predictors built from the "
             "checkpoint copies")
    if warmups != {"urban": 1, "forest": 0}:
        fail(f"pipeline_two_model: warm-up forwards {warmups} (expected one, "
             f"of the urban model, which predicts first)")
    if launches != {"k1": 0, "k5": 2 * (batches + 1), "k6": 0}:
        fail(f"pipeline_two_model: ROI launches {launches} for {batches} "
             f"batches and the urban warm-up's forward under TD_ROI_FLAT=0 "
             f"(expected K5 twice per forward and no other)")
    if not row["crowns_fused_west"] or not row["crowns_fused_east"]:
        fail("pipeline_two_model: the fused layer lacks crowns on one side "
             "of the outline")
    if written.get(f"processed_{big}.gpkg", 0) == 0:
        fail(f"pipeline_two_model: no processed crowns: {written}")
    state["two_model"] = row

    # (1) a second call on the finished output predicts nothing
    config2 = make_config()
    _launches(reset=True)
    with layout_env("levels"):
        t0 = time.time()
        outputs2 = detection.process_files(config2)
        resume_s = time.time() - t0
    counts = _launches(*ROI)
    emit({"phase": "pipeline_two_model_resume", "seconds": resume_s,
          "launches": counts,
          "predictor_built": "_predictor_cache" in config2,
          "outputs": [Path(p).name for p in outputs2]})
    if any(counts.values()) or "_predictor_cache" in config2:
        fail("pipeline_two_model: the resumed run predicted again")
    if sorted(outputs2) != sorted(outputs):
        fail("pipeline_two_model: the resumed run returned other outputs")
    for cfg in (config, config2):
        for handler in list(cfg["logger"].handlers):
            cfg["logger"].removeHandler(handler)
            handler.close()
    config.pop("_predictor_cache", None)
    del cache
    torch.cuda.empty_cache()

    # (2) the Predictor of phase 3 over the same 16 tiles under
    # TD_ROI_RESIDENT=1, against that phase's pass in the default layout
    pred = state["pred"]
    out_res = workdir / "pred_resident"
    _launches(reset=True)                    # just before the main path
    with layout_env("resident"):
        t0 = time.time()
        n_written = pred(str(state["tif"]), state["meta"], str(out_res))
        torch.cuda.synchronize()
        res_wall = time.time() - t0
    counts = _launches(*ROI)                 # just after
    res_batches = math.ceil(n_written / pred.batch_size)
    flat, mine = _tile_files(state["pred_timed_dir"]), _tile_files(out_res)
    differ = sorted(name for name in flat if mine.get(name) != flat[name])
    row = {"phase": "predictor_resident", "tiles": n_written,
           "batches": res_batches, "wall_s": res_wall, "launches": counts,
           "tile_files": len(mine), "tile_files_of_the_default_pass":
           len(flat), "files_that_differ": differ,
           "crowns": sum(len(json.loads(b)) for b in mine.values()),
           "tolerance": "byte-for-byte equal tile files (K6 and K1 share "
                        "pool_box_bf16; K6's refolded hats are K1's shifted "
                        "by its clamp)"}
    emit(row)
    if counts != {"k1": 0, "k5": 0, "k6": 2 * res_batches}:
        fail(f"predictor_resident: ROI launches {counts} for {res_batches} "
             f"batches under TD_ROI_RESIDENT=1 (expected K6 twice per batch "
             f"and no other)")
    if sorted(mine) != sorted(flat) or differ:
        fail(f"predictor_resident: the tile files differ from the default "
             f"pass's: {row}")
    state["resident"] = row


# --- phase 6b: the bench -------------------------------------------------------

BENCH_SHEET_TILES = 400          # the bench's 1 km^2 sheet in 50 m tiles
BENCH_PIPELINE_PASSES = 2
# every rate of the bench's line, and the other numbers that must be > 0
BENCH_RATES = ("value", "pipelined_tiles_per_sec_min",
               "pipelined_tiles_per_sec_max", "serial_tiles_per_sec",
               "pipeline_tiles_per_sec", "pipeline_tiles_per_sec_excl_compile",
               "pipeline_first_tiles_per_sec")
BENCH_POSITIVE = ("vs_baseline", "p50_per_tile_ms", "pipeline_wall_s",
                  "pipeline_first_wall_s", "pipelined_between_run_n")


def bench_k1_launches(bench) -> int:
    """K1 launches that one ``BENCH_DETAIL=1`` run of the bench on the card
    needs, from its code: two per forward (box and mask pool); the model
    part's forwards (the detail runs and their warm one, the first run, the
    compute-only runs, the stream, the device thread's warm forward, and
    each pipelined pass one batch ahead of its ``max(iters, 5)``), and each
    pipeline pass's batches of the example configuration over the sheet's
    tiles plus its compile warm-up's forward (``compile_warmup`` is on in
    the example configuration, and each pass starts in a fresh
    workspace)."""
    from treedetection_tpu_torch.config import load_config
    _, _, iters, passes = bench.bench_setup(on_cpu=False)
    forwards = (bench.DETAIL_RUNS + 1) + 1 + bench.COMPUTE_RUNS + iters \
        + 1 + passes * (max(iters, 5) + 1)
    example = load_config(str(bench.EXAMPLE))
    warmups = 1 if example.get("compile_warmup", True) else 0
    batches = BENCH_PIPELINE_PASSES * (warmups + math.ceil(
        BENCH_SHEET_TILES / example["batch_size"]))
    return 2 * (forwards + batches)


def _bench_line(phase, text, keys):
    """The bench's last line of ``text``, parsed and checked."""
    lines = text.strip().splitlines()
    try:
        line = json.loads(lines[-1])
    except (IndexError, ValueError):
        fail(f"{phase}: the bench's last line is not JSON: {lines[-3:]}")
    if set(line) != keys:
        fail(f"{phase}: keys {sorted(line)}, expected {sorted(keys)}")
    bad = [k for k in BENCH_RATES + BENCH_POSITIVE if k in line and not (
        isinstance(line[k], (int, float)) and math.isfinite(line[k])
        and line[k] > 0)]
    if bad or line["model"] != "mask_rcnn_r101_fpn_1024":
        fail(f"{phase}: {bad} not finite and positive, or the model is "
             f"{line['model']}: {line}")
    if line["gpu"] != gpu_line():
        fail(f"{phase}: gpu {line['gpu']!r}, nvidia-smi says {gpu_line()!r}")
    return line


def bench_k1_check(bench, model, tiles):
    """K1 against its plain version at the bench's own shapes, in bfloat16
    at the kernel phase's tolerance: the bench's model on its staged batch,
    the box pool over the proposals (N = batch x 512, R = 7), the mask pool
    over the forward's detections (N = batch x 100, R = 14; all invalid at
    random init) and, so that it also sees crown-sized boxes, over each
    image's first 100 proposals.  -> one row per pool."""
    import torch
    from treedetection_tpu_torch.models.mask_rcnn import FPN_STRIDES
    from treedetection_tpu_torch.models.rpn import generate_proposals
    from treedetection_tpu_torch.ops.image import normalize_bgr
    from treedetection_tpu_torch.ops.kernels.roi_align import (
        roi_pool_patches_flat, roi_pool_patches_flat_reference)
    from treedetection_tpu_torch.ops.roi_align import flat_pool_inputs
    c = model.cfg
    rows = {}
    with torch.no_grad():
        x = normalize_bgr(tiles)
        feats, logits, deltas = model.forward_features(x)
        props = generate_proposals(
            logits, deltas, model.anchors(x.device), c.input_size,
            c.rpn_pre_nms_topk, c.rpn_post_nms_topk, c.rpn_nms_threshold)
        out = model(x)
        for name, boxes, r in (
                ("box/proposals", props.boxes, c.box_pool),
                ("mask/detections", out.boxes, c.mask_pool),
                ("mask/proposals", props.boxes[:, :c.max_detections],
                 c.mask_pool)):
            p = flat_pool_inputs(feats[:4], boxes, r, FPN_STRIDES[:4])
            args = (p.kcat, p.rows, p.cols, p.ay, p.ax, r)
            got = roi_pool_patches_flat(*args)
            ref = roi_pool_patches_flat_reference(*args)
            torch.cuda.synchronize()
            dname = str(got.dtype).split(".")[-1]
            ok, err, tol = check_close(got, ref, "bfloat16")
            rows[name] = {"n": int(p.rows.shape[0]), "resolution": r,
                          "dtype": dname, "max_abs_err": err,
                          "tolerance": tol, "vs_plain": ulp_errors(got, ref)}
            if dname != "bfloat16" or not ok \
                    or not torch.isfinite(got.float()).all():
                fail(f"bench: K1 at the bench's {name} pool: {rows[name]}")
        rows["mask/detections"]["valid"] = int(out.valid.sum())
    return rows


def _device_busy_ms(trace: Path):
    """The union of the kernel, copy and memset intervals of a Chrome
    trace, in ms, and their count; (None, 0) when it holds none."""
    events = json.loads(trace.read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and "dur" in e)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return (busy / 1e3 if spans else None), len(spans)


def bench_pass_profile(bench, model, tiles, workdir: Path, out_dir):
    """The bench's pipelined pass on its warmed device thread, the same on
    a new thread (as the Predictor starts one per call), and the same
    forwards fetched one after another on this thread; twice each in turns
    on the host clock, every forward call timed where it runs, then each
    once under torch.profiler (CUDA activity): the device's busy ms (the
    union of its kernel and copy intervals) and idle share of the run's
    wall.  The Chrome traces go to ``out_dir`` when one is given."""
    forward = bench.make_forward(model)
    _, batch, iters, _ = bench.bench_setup(on_cpu=False)
    n = max(iters, 5) + 1            # the forwards in a pipelined window
    calls: list = []

    def timed(batch_tiles, mark=None):
        t = time.perf_counter()
        result = forward(batch_tiles, mark=mark)
        calls.append((time.perf_counter() - t) * 1e3)
        return result

    def serial():
        for _ in range(n):
            bench.fetch(timed(tiles))

    def new_thread():
        with bench.device_thread_pool() as fresh:
            bench.pipelined_pass(timed, tiles, batch, iters, fresh)

    with bench.device_thread_pool() as device_thread:
        def pipelined():
            bench.pipelined_pass(timed, tiles, batch, iters, device_thread)
        modes = {"serial": serial, "pipelined": pipelined,
                 "pipelined_new_thread": new_thread}
        serial()                         # warm this thread
        pipelined()                      # and the device thread
        runs = {m: [] for m in modes}
        for mode in list(modes) * 2:
            _time_mode(mode, modes[mode], calls, runs)
        profiled = {m: _profile_mode(m, run, calls, workdir, out_dir)
                    for m, run in modes.items()}
    return {"host_clock": runs, "profiled": profiled,
            "note": "a pipelined pass runs max(iters, 5) + 1 forwards in "
                    "its window and counts max(iters, 5) batches"}


def _time_mode(mode, run, calls, runs):
    """One host-clock run of a mode, appended to ``runs[mode]``."""
    import torch
    calls.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    runs[mode].append({"wall_ms": wall, "forwards": len(calls),
                       "ms_per_forward": wall / len(calls),
                       "forward_call_ms": [round(v, 2) for v in calls]})


def _profile_mode(mode, run, calls, workdir: Path, out_dir):
    """One run of a mode under torch.profiler -> its wall, the device's
    busy ms and idle share; its Chrome trace copied to ``out_dir``."""
    import gzip
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile
    calls.clear()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    trace = workdir / f"bench_{mode}_trace.json"
    prof.export_chrome_trace(str(trace))
    busy, n_spans = _device_busy_ms(trace)
    if out_dir is not None:      # gzipped: each trace holds ~30 MB of JSON
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(trace, "rb") as src, \
                gzip.open(out_dir / f"{trace.name}.gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
    trace.unlink()
    return {"wall_ms": wall, "forwards": len(calls),
            "device_busy_ms": busy, "device_intervals": n_spans,
            "device_busy_ms_per_forward":
                busy / len(calls) if busy is not None else None,
            "device_idle_share": 1 - busy / wall if busy is not None
            else None}


def phase_bench(state, workdir: Path, profile_dir=None):
    """``bench.main`` in this process with ``BENCH_DETAIL=1`` (K1's launches
    counted from just before to just after), then K1 against its plain
    version at the bench's shapes and the pipelined pass profiled beside
    serial forwards, then ``treedetection-torch bench`` with
    ``TD_BENCH_SKIP_PIPELINE=1``."""
    import io

    import torch
    from treedetection_tpu_torch import bench
    _clear_layout_env()
    for name in ("TD_PAIRS_DEVICE", "TD_BENCH_SKIP_PIPELINE",
                 "TD_BENCH_PIPELINE_PASSES"):
        os.environ.pop(name, None)
    expected = bench_k1_launches(bench)
    out, err = io.StringIO(), io.StringIO()
    os.environ["BENCH_DETAIL"] = "1"
    _launches(reset=True)                   # just before the main path
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = bench.main(["--device", "cuda"])
    finally:
        del os.environ["BENCH_DETAIL"]
        sys.stderr.write(err.getvalue())
        sys.stderr.flush()
    seconds = time.time() - t0
    launches = _launches(*ROI)              # just after
    if rc != 0:
        fail(f"bench: exit {rc}")
    stages = []
    for ln in err.getvalue().splitlines():
        if ln.startswith("bench-detail:"):
            words = ln.split()
            stages.append({"stage": words[1].lstrip("."),
                           "cumulative_ms": float(words[2][:-len("ms/batch")]),
                           "delta_ms": float(ln.split("(+")[1].split("ms")[0])})
    emit({"phase": "bench_detail", "stages": stages,
          "timed_by": "CUDA events between the stages of one forward, "
                      "median of 3 runs"})
    if [s["stage"] for s in stages] != list(bench.STAGES):
        fail(f"bench: detail stages {stages}")
    line = _bench_line("bench", out.getvalue(), bench.MODEL_KEYS
                       | bench.BAND_KEYS | bench.PIPELINE_KEYS)
    row = {"phase": "bench", "seconds": seconds, "launches": launches,
           "k1_expected": expected, "line": line}
    emit(row)
    if line["pipeline_tiles"] != BENCH_SHEET_TILES \
            or line["pipeline_crowns"] <= 0:
        fail(f"bench: {line['pipeline_tiles']} tiles (expected "
             f"{BENCH_SHEET_TILES}) and {line['pipeline_crowns']} crowns")
    if launches != {"k1": expected, "k5": 0, "k6": 0}:
        fail(f"bench: ROI launches {launches}, the code needs K1 {expected} "
             f"and no other")
    torch.cuda.empty_cache()

    t0 = time.time()
    cfg, batch, _, _ = bench.bench_setup(on_cpu=False)
    model = bench.serving_model(cfg, torch.device("cuda", 0))
    tiles = bench.random_tiles(np.random.default_rng(0), batch,
                               cfg.input_size).to("cuda")
    row["k1_at_bench_shapes"] = bench_k1_check(bench, model, tiles)
    emit({"phase": "bench_k1", "pools": row["k1_at_bench_shapes"]})
    row["pass_profile"] = bench_pass_profile(bench, model, tiles, workdir,
                                             profile_dir)
    emit({"phase": "bench_profile", "seconds": time.time() - t0,
          **row["pass_profile"]})
    del model, tiles
    torch.cuda.empty_cache()

    t0 = time.time()
    os.environ["TD_BENCH_SKIP_PIPELINE"] = "1"
    try:
        cli_out = _port_cli("bench")
    finally:
        del os.environ["TD_BENCH_SKIP_PIPELINE"]
    cli_line = _bench_line("bench_cli", cli_out,
                           bench.MODEL_KEYS | bench.BAND_KEYS)
    emit({"phase": "bench_cli", "seconds": time.time() - t0,
          "line": cli_line})
    state["bench"] = row


# --- phase 7: training ---------------------------------------------------------

# example/train_full.py's configuration: R50, 1024^2, batch 4, 1000/512
# proposals, 100 detections, bf16, remat, batch norm, preset scratch,
# freeze 0; the tiles 50 m with a 20 m buffer, max_gt 48, uint8 shards of 8
TRAIN_SIZE = 1024
TRAIN_BATCH = 4
TRAIN_STEPS = 30           # one validation, at the last step
TRAIN_TIMING_WARMUP = 3    # steps left out of the median s/step
FINETUNE_STEPS = 10
CHECK_SIZE = 256           # the fp32 step held card against CPU
CHECK_DEVICES = ("cuda", "cpu")
# the tensors whose gradients the card-against-CPU step compares
CHECK_GRADS = ("backbone.bottom_up.stem.conv.weight",
               "backbone.bottom_up.res5.0.conv2.conv.weight",
               "backbone.fpn.output2.weight", "rpn_head.conv.weight",
               "box_head.fc1.weight", "mask_head.mask_fcn1.weight")
# card against CPU, fp32 without TF32: each loss term within LOSS_RTOL of
# the CPU's; each named gradient within GRAD_L2_RTOL of the CPU's in L2 (a
# pre-activation that rounds to the other side of 0 on one device moves
# one position's contribution, so a max-abs bound would read rounding noise)
LOSS_RTOL = 1e-4
GRAD_L2_RTOL = 1e-2


def write_training_labels(tif: Path, gpkg: Path, seed: int = 1) -> int:
    """The synthetic raster's generator with its crown discs as polygons
    (32-gons in map coordinates) -> the number of crowns."""
    from treedetection_tpu_torch.vector import write_gpkg
    tif.parent.mkdir(parents=True, exist_ok=True)
    rings = disc_rings(write_synthetic_raster(tif, seed=seed))
    write_gpkg(str(gpkg), rings, [{"Confidence_score": 1.0}] * len(rings))
    return len(rings)


def _train_run(train_model, ds, val, cfg, tc, **kw):
    import torch
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    state_dict, hist = train_model(ds, val_dataset=val, model_cfg=cfg,
                                   train_cfg=tc, **kw)
    torch.cuda.synchronize()
    losses = hist["total_loss"]
    if not all(math.isfinite(v) for v in losses + hist["val_loss"]):
        fail(f"train: non-finite loss {losses} {hist['val_loss']}")
    return state_dict, hist, {
        "steps": len(losses), "wall_s": time.time() - t0,
        "s_per_step_median": statistics.median(
            hist["step_s"][TRAIN_TIMING_WARMUP:]),
        "first_step_s": hist["step_s"][0],
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "loss_first": losses[0], "loss_last": losses[-1],
        "val_loss": hist["val_loss"]}


def phase_train(state, workdir: Path):
    import dataclasses
    import torch
    from treedetection_tpu_torch import prediction
    from treedetection_tpu_torch.models.convert import (
        fold_batch_stats, load_checkpoint, save_checkpoint_npz,
        to_flax_params)
    from treedetection_tpu_torch.models.mask_rcnn import (
        MaskRCNN, MaskRCNNConfig)
    from treedetection_tpu_torch.train import TrainConfig, train_model
    from treedetection_tpu_torch.train.data import (
        ShardDataset, make_training_tiles, train_test_split, write_shards)
    from treedetection_tpu_torch.train.train import (
        _frozen_prefixes, make_optimizer, make_train_step)
    _clear_layout_env()
    t_phase = time.time()
    tdir = workdir / "train"
    tif, gpkg = tdir / "rgb.tif", tdir / "crowns.gpkg"
    n_crowns = write_training_labels(tif, gpkg)

    # 1. tiles and shards, as train_full.py cuts them
    t0 = time.time()
    shards = write_shards(make_training_tiles(
        str(tif), str(gpkg), tile_size_m=50, buffer_m=20,
        input_size=TRAIN_SIZE, max_gt=48, store_uint8=True),
        str(tdir / "shards"), shard_size=8)
    (train_shards, val_shards), = train_test_split(shards, 0.15)
    shards_s = time.time() - t0
    with np.load(shards[0]) as z:
        shapes = {k: (list(z[k].shape), str(z[k].dtype)) for k in z.files}
    if shapes["image"][0][1:] != [TRAIN_SIZE, TRAIN_SIZE, 3] or \
            shapes["masks"][0][1:] != [48, TRAIN_SIZE // 4, TRAIN_SIZE // 4] \
            or not train_shards or not val_shards:
        fail(f"train: shards {shapes}, train {train_shards}, val "
             f"{val_shards}")

    # 2. from scratch at train_full.py's width, with remat and without
    mc = MaskRCNNConfig(depth=50, input_size=TRAIN_SIZE,
                        rpn_pre_nms_topk=1000, rpn_post_nms_topk=512,
                        max_detections=100, bf16=True, remat=True,
                        norm="batch")
    tc = TrainConfig.from_preset(
        "scratch", max_iter=TRAIN_STEPS, ims_per_batch=TRAIN_BATCH,
        max_gt=48, backbone_freeze=0, eval_period=TRAIN_STEPS, patience=10,
        max_eval_batches=2)
    runs = {}
    for remat in (True, False):
        sd, _, runs[f"remat_{'on' if remat else 'off'}"] = _train_run(
            train_model, ShardDataset(train_shards, TRAIN_BATCH),
            ShardDataset(val_shards, TRAIN_BATCH, shuffle=False),
            dataclasses.replace(mc, remat=remat), tc)
        if remat:
            trained = {k: v.cpu() for k, v in sd.items()}
        del sd
    on, off = runs["remat_on"], runs["remat_off"]
    first_equal = abs(on["loss_first"] - off["loss_first"]) <= \
        1e-6 * abs(off["loss_first"])

    # 3. fine-tune the example checkpoint (preset update: freeze 3, frozen
    # norm) on one fixed batch
    init = load_checkpoint(str(NPZ), depth=50)
    fixed = next(iter(ShardDataset(train_shards, TRAIN_BATCH,
                                   shuffle=False)))
    ft_sd, _, finetune = _train_run(
        train_model, [fixed], None,
        dataclasses.replace(mc, norm="frozen"),
        TrainConfig.from_preset("update", max_iter=FINETUNE_STEPS,
                                ims_per_batch=TRAIN_BATCH, max_gt=48),
        init_params=init)
    prefixes = tuple(_frozen_prefixes(3))
    frozen_same = all(torch.equal(ft_sd[k].cpu(), v)
                      for k, v in init.items() if k.startswith(prefixes))
    heads = ("rpn_head.conv.weight", "box_head.fc1.weight",
             "mask_head.predictor.weight")
    heads_changed = all(not torch.equal(ft_sd[k].cpu(), init[k])
                        for k in heads)
    finetune.update(frozen_unchanged=frozen_same, heads_changed=heads_changed,
                    frozen_tensors=sum(k.startswith(prefixes) for k in init))
    del ft_sd

    # 4. one fp32 step at CHECK_SIZE on the card and on the CPU
    ex = make_training_tiles(str(tif), str(gpkg), tile_size_m=50,
                             buffer_m=20, input_size=CHECK_SIZE, max_gt=48,
                             store_uint8=True)
    small = [next(ex), next(ex)]
    batch = {k: np.stack([e[k] for e in small]) for k in small[0]}
    cfg32 = dataclasses.replace(mc, input_size=CHECK_SIZE, bf16=False,
                                remat=False, norm="frozen")
    step_out = {}
    for dev in CHECK_DEVICES:
        model = MaskRCNN(cfg32)
        model.load_state_dict(init)
        model.to(dev)
        step = make_train_step(model, make_optimizer(
            TrainConfig.from_preset("update", backbone_freeze=0), model))
        metrics = step({k: torch.from_numpy(v).to(dev)
                        for k, v in batch.items()})
        params = dict(model.named_parameters())
        step_out[dev] = ({k: float(v) for k, v in metrics.items()},
                         {n: params[n].grad.detach().cpu().double()
                          for n in CHECK_GRADS})
    (m_gpu, g_gpu), (m_cpu, g_cpu) = (step_out[d] for d in CHECK_DEVICES)
    loss_rel = {k: abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-30)
                for k in m_cpu}
    grad_l2 = {n: float((g_gpu[n] - g_cpu[n]).norm()
                        / max(float(g_cpu[n].norm()), 1e-30))
               for n in CHECK_GRADS}
    grad_max = {n: float((g_gpu[n] - g_cpu[n]).abs().max()
                         / max(float(g_cpu[n].abs().max()), 1e-30))
                for n in CHECK_GRADS}

    # 5. serve the from-scratch checkpoint, folded, through the Predictor
    npz = tdir / "trained.npz"
    save_checkpoint_npz(str(npz), fold_batch_stats(to_flax_params(trained)))
    pred = prediction.Predictor(predictor_config(workdir), str(npz))
    if pred.used_random_init:
        fail("train: the trained checkpoint did not load")
    out = workdir / "pred_trained"
    _launches(reset=True)               # just before the serving pass
    written = pred(str(state["tif"]), state["meta"], str(out))
    torch.cuda.synchronize()
    counts = _launches(*ROI)            # just after
    batches = int(prediction.LAST_RUN_STATS["batches"])
    files = sorted(out.glob("Prediction_*.json"))
    crowns = _count_crowns(files, "train")

    row = {"phase": "train", "crowns_labelled": n_crowns,
           "shards": len(shards), "train_shards": len(train_shards),
           "val_shards": len(val_shards), "shard_arrays": shapes,
           "shards_s": shards_s, "config": {
               "depth": 50, "input_size": TRAIN_SIZE, "batch": TRAIN_BATCH,
               "proposals": [1000, 512], "bf16": True, "norm": "batch",
               "preset": "scratch", "freeze": 0},
           **runs, "remat_first_loss_equal": first_equal,
           "remat_saves_gib": off["peak_gib"] - on["peak_gib"],
           "finetune": finetune,
           "card_vs_cpu": {"size": CHECK_SIZE, "dtype": "float32",
                           "tf32": False, "loss_gpu": m_gpu,
                           "loss_rel_err": loss_rel,
                           "grad_l2_rel_err": grad_l2,
                           "grad_max_rel_err": grad_max,
                           "tolerance": {"loss_rtol": LOSS_RTOL,
                                         "grad_l2_rtol": GRAD_L2_RTOL}},
           "serve": {"tiles": written, "files": len(files),
                     "batches": batches, "crowns": crowns,
                     "launches": counts,
                     "npz_mb": npz.stat().st_size / 1e6},
           "k1_launches": counts["k1"],
           "seconds": time.time() - t_phase}
    emit(row)
    if not first_equal:
        fail(f"train: the first loss differs with remat on and off: "
             f"{on['loss_first']} vs {off['loss_first']}")
    if not finetune["loss_last"] < finetune["loss_first"]:
        fail(f"train: the fine-tune loss did not fall: {finetune}")
    if not frozen_same or not heads_changed:
        fail(f"train: fine-tune frozen stages unchanged {frozen_same}, "
             f"heads changed {heads_changed}")
    if max(loss_rel.values()) > LOSS_RTOL or \
            max(grad_l2.values()) > GRAD_L2_RTOL:
        fail(f"train: the card's step disagrees with the CPU's: losses "
             f"{loss_rel}, gradients {grad_l2}")
    if written != 16 or len(files) != 16:
        fail(f"train: served {written} tiles, {len(files)} files")
    if counts != {"k1": 2 * batches, "k5": 0, "k6": 0}:
        fail(f"train: launches {counts} for {batches} batches (expected K1 "
             f"twice per batch and no other)")
    state["train"] = row
    state["pred_trained_dir"] = out
    state["train_inputs"] = {"train_shards": train_shards,
                             "val_shards": val_shards, "config": mc,
                             "check_batch": batch}


# --- phase 7b: the multi-device train step, two ranks on the one card --------

SHARDED_RANKS = 2
SHARDED_STEPS = 10         # at full width, one validation at the last step
SHARDED_CHECK_STEPS = 3    # the fp32 check against one process
SHARDED_CHILD_TIMEOUT_S = 600
SHARDED_DEVICE = "cuda:0"  # both ranks share the one card
# the fp32 check, two ranks against one process at the global batch (the
# port's CPU tests' tolerances): each tensor's update within UPDATE_L2_RTOL
# of its update's L2 norm (+ 1e-6 of the tensor's, + 1e-12), the running
# statistics within STATS_RTOL of the largest; losses within LOSS_RTOL
UPDATE_L2_RTOL = 3e-2
STATS_RTOL = 1e-4
# after an update, the classifier's term (and the total with it) depends on
# which proposals survive top-k and NMS over RPN scores that differ in the
# last bits: a background proposal more or less moves it by up to ~1e-3,
# above LOSS_RTOL, so at steps 2-3 LOSS_RTOL holds the RPN terms, which do
# not depend on the proposals, and the rest is reported; the updates hold
# every step's gradients through UPDATE_L2_RTOL
PROPOSAL_FREE_TERMS = ("rpn_objectness", "rpn_regression")


def _state_digest(state_dict) -> str:
    """sha256 over the state dict's keys and each tensor's bytes in logical
    order: equal digests are equal replicas, bit for bit."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(state_dict):
        h.update(k.encode())
        h.update(state_dict[k].detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def _deterministic():
    """torch's deterministic algorithms (warn-only) and cuDNN's inside the
    block, so that the fp32 check compares the sharding and not run-to-run
    noise: without them, atomics in the backward move the one-process
    3-step loss by ~1e-4 against itself.  Yields a list that receives, at
    the block's end, the ops torch warned have no deterministic
    implementation."""
    import warnings
    import torch
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.backends.cudnn.deterministic)
    ops = []
    with warnings.catch_warnings(record=True) as records:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        try:
            yield ops
        finally:
            torch.use_deterministic_algorithms(before[0])
            torch.backends.cudnn.deterministic = before[1]
    ops += sorted({str(w.message).split(" does not have")[0]
                   for w in records if "deterministic" in str(w.message)})


def train_child(root: Path) -> None:
    """One rank of the ``train_sharded`` phase (run as ``chip_smoke.py
    --train-child ROOT`` with torchrun's environment): the group over gloo,
    the fp32 check's steps at the global batch, then ``train_model(mesh=
    group)`` at full width; one JSON line of its losses, times, peak and
    the digest of its state dict."""
    import pickle
    from datetime import timedelta
    import torch
    import torch.distributed as dist
    from treedetection_tpu_torch.models.mask_rcnn import MaskRCNN
    from treedetection_tpu_torch.train import train_model
    from treedetection_tpu_torch.train.data import ShardDataset
    from treedetection_tpu_torch.train.train import (
        make_optimizer, make_sharded_train_step)
    dist.init_process_group(
        "gloo", timeout=timedelta(seconds=SHARDED_CHILD_TIMEOUT_S))
    rank, group = dist.get_rank(), dist.group.WORLD
    with open(root / "spec.pkl", "rb") as fh:
        spec = pickle.load(fh)

    # 1. the fp32 check's steps at the global batch
    model = MaskRCNN(spec["check_config"])
    model.load_state_dict(torch.load(root / "check_init.pt"))
    model.to(SHARDED_DEVICE)
    tc = spec["check_train_config"]
    step = make_sharded_train_step(model, make_optimizer(tc, model), group,
                                   tc)
    batch = {k: torch.from_numpy(v).to(SHARDED_DEVICE)
             for k, v in spec["check_batch"].items()}
    with _deterministic() as nondet:
        check_losses = [{k: float(v) for k, v in step(batch).items()}
                        for _ in range(SHARDED_CHECK_STEPS)]
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               root / f"check_{rank}.pt")
    del model, step, batch

    # 2. full width from scratch, validation at the last step
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    state_dict, hist = train_model(
        ShardDataset(spec["train_shards"], spec["batch"]),
        ShardDataset(spec["val_shards"], spec["batch"], shuffle=False),
        model_cfg=spec["config"], train_cfg=spec["train_config"],
        mesh=group, checkpoint_path=str(root / "trained.npz"),
        device=SHARDED_DEVICE)
    torch.cuda.synchronize()
    wall = time.time() - t0
    losses = hist["total_loss"]
    # what the step's collectives cost alone on this group: the flat
    # gradient, and one batch norm's stacked channel sums (2 x 256)
    n_grad = sum(v.numel() for k, v in state_dict.items()
                 if not k.endswith((".mean", ".var")))
    allreduce_ms = {}
    for name, numel, reps in (("gradient_flat", n_grad, 5),
                              ("bn_sums_2x256", 512, 50)):
        buf = torch.zeros(numel, device=SHARDED_DEVICE)
        dist.all_reduce(buf)
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            dist.all_reduce(buf)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        allreduce_ms[name] = statistics.median(times)
    emit({"phase": "train_sharded_rank", "rank": rank,
          "gradient_floats": n_grad, "allreduce_ms": allreduce_ms,
          "ranks": dist.get_world_size(), "check_losses": check_losses,
          "check_nondeterministic_ops": nondet,
          "steps": len(losses), "wall_s": wall,
          "s_per_step_median": statistics.median(
              hist["step_s"][TRAIN_TIMING_WARMUP:]),
          "first_step_s": hist["step_s"][0],
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "loss_first": losses[0], "loss_last": losses[-1],
          "losses": losses, "val_loss": hist["val_loss"],
          "digest": _state_digest(state_dict)})
    dist.destroy_process_group()


def _loss_errors(got, ref):
    """Per step, each loss term's relative error against ``ref``'s."""
    return [{k: abs(g[k] - r[k]) / max(abs(r[k]), 1e-30) for k in r}
            for g, r in zip(got, ref)]


def _update_errors(before, ref, got):
    """Per tensor, ``got``'s update (or running statistic) against
    ``ref``'s as a share of its tolerance (<= 1 passes), and the frozen
    tensors that moved."""
    shares = {}
    for k, r in ref.items():
        r, g, b = r.double(), got[k].double(), before[k].double()
        if k.endswith((".mean", ".var")):
            shares[k] = float((g - r).abs().max()) / (
                STATS_RTOL * max(float(r.abs().max()), 1.0))
            continue
        ref_up = r - b
        shares[k] = float((g - b - ref_up).norm()) / (
            UPDATE_L2_RTOL * float(ref_up.norm()) + 1e-6 * float(r.norm())
            + 1e-12)
    return shares


def phase_train_sharded(state, workdir: Path):
    """``make_sharded_train_step`` and ``train_model(mesh=group)``: two
    processes on the one card over gloo (torchrun's environment, both on
    cuda:0): the fp32 check against one process at the global batch, 10
    steps at full width, and rank 0's checkpoint folded and served."""
    import dataclasses
    import pickle
    import torch
    from treedetection_tpu_torch import prediction
    from treedetection_tpu_torch.models.convert import (
        fold_batch_stats, load_checkpoint, save_checkpoint_npz,
        to_flax_params)
    from treedetection_tpu_torch.models.mask_rcnn import (
        MaskRCNN, create_model)
    from treedetection_tpu_torch.train import TrainConfig
    from treedetection_tpu_torch.train.train import (
        make_optimizer, make_train_step)
    _clear_layout_env()
    t_phase = time.time()
    inputs = state["train_inputs"]
    root = workdir / "train_sharded"
    root.mkdir()
    batch = TRAIN_BATCH                                # 2 per rank
    mc = inputs["config"]
    check_cfg = dataclasses.replace(mc, input_size=CHECK_SIZE, bf16=False)
    check_tc = TrainConfig.from_preset("scratch", backbone_freeze=0)
    tc = TrainConfig.from_preset(
        "scratch", max_iter=SHARDED_STEPS, ims_per_batch=batch, max_gt=48,
        backbone_freeze=0, eval_period=SHARDED_STEPS, patience=10,
        max_eval_batches=2)
    before = {k: v.detach().clone()                    # seeded
              for k, v in create_model(check_cfg).state_dict().items()}
    torch.save(before, root / "check_init.pt")
    with open(root / "spec.pkl", "wb") as fh:
        pickle.dump({"check_config": check_cfg, "check_train_config":
                     check_tc, "check_batch": inputs["check_batch"],
                     "config": mc, "train_config": tc, "batch": batch,
                     "train_shards": inputs["train_shards"],
                     "val_shards": inputs["val_shards"]}, fh)

    # 1. one process at the global batch, twice: the fp32 check's
    # reference, and the spread of the step against itself
    def one_process():
        model = MaskRCNN(check_cfg)
        model.load_state_dict(before)
        model.to(SHARDED_DEVICE)
        step = make_train_step(model, make_optimizer(check_tc, model),
                               check_tc)
        tb = {k: torch.from_numpy(v).to(SHARDED_DEVICE)
              for k, v in inputs["check_batch"].items()}
        with _deterministic() as nondet:
            losses = [{k: float(v) for k, v in step(tb).items()}
                      for _ in range(SHARDED_CHECK_STEPS)]
        return losses, {k: v.cpu() for k, v in model.state_dict().items()}, \
            nondet

    (ref_losses, ref_state, nondet), (rep_losses, rep_state, _) = \
        one_process(), one_process()
    torch.cuda.empty_cache()

    # 2. the two ranks: the check's steps, then full width
    t0 = time.time()
    rows = _spawn_ranks(root, "--train-child", SHARDED_RANKS,
                        SHARDED_CHILD_TIMEOUT_S,
                        '{"phase": "train_sharded_rank"', "train_sharded",
                        one_host=True, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    ranks_wall = time.time() - t0
    for row in rows:
        emit({k: v for k, v in row.items() if k != "losses"})
    checks = [torch.load(root / f"check_{r}.pt")
              for r in range(SHARDED_RANKS)]
    check_equal = all(torch.equal(checks[0][k], c[k])
                      for c in checks[1:] for k in checks[0])
    loss_rel = _loss_errors(rows[0]["check_losses"], ref_losses)
    # held: every term before the first update, then the terms that do not
    # depend on which proposals survive top-k and NMS
    held = max(v for i, errs in enumerate(loss_rel) for k, v in errs.items()
               if i == 0 or k in PROPOSAL_FREE_TERMS)
    shares = _update_errors(before, ref_state, checks[0])
    worst = sorted(shares.items(), key=lambda kv: -kv[1])[:3]
    rep_worst = max(_update_errors(before, ref_state, rep_state).items(),
                    key=lambda kv: kv[1])
    rep_rel = _loss_errors(rep_losses, ref_losses)
    digests = {row["digest"] for row in rows}
    losses = rows[0]["losses"]

    # 3. rank 0's checkpoint, folded and served
    ckpt = root / "trained.npz"
    trained = load_checkpoint(str(ckpt), depth=50) if ckpt.is_file() else {}
    ckpt_equal = bool(trained) and _state_digest(trained) in digests
    npz = root / "served.npz"
    save_checkpoint_npz(str(npz), fold_batch_stats(to_flax_params(trained)))
    pred = prediction.Predictor(predictor_config(workdir), str(npz))
    if pred.used_random_init:
        fail("train_sharded: the trained checkpoint did not load")
    out = workdir / "pred_trained_sharded"
    _launches(reset=True)               # just before the serving pass
    written = pred(str(state["tif"]), state["meta"], str(out))
    torch.cuda.synchronize()
    counts = _launches(*ROI)            # just after
    batches = int(prediction.LAST_RUN_STATS["batches"])
    files = sorted(out.glob("Prediction_*.json"))
    crowns = _count_crowns(files, "train_sharded")

    one = state["train"]["remat_on"]
    row = {"phase": "train_sharded", "ranks": SHARDED_RANKS,
           "backend": "gloo", "device": SHARDED_DEVICE,
           "note": "both ranks share one card: no multi-GPU speed is "
                   "measured, and NCCL is untried",
           "card": gpu_line(),
           "fp32_check": {
               "size": CHECK_SIZE, "global_batch": 2, "norm": "batch",
               "remat": check_cfg.remat, "tf32": False,
               "steps": SHARDED_CHECK_STEPS, "losses_one_process":
               ref_losses, "losses_ranks": [r["check_losses"] for r in rows],
               "loss_rel_err": loss_rel, "loss_rel_err_held": held,
               "loss_terms_held": "every term at step 1; at later steps "
                                  + ", ".join(PROPOSAL_FREE_TERMS),
               "worst_update_share_of_tolerance": worst,
               "one_process_again": {"loss_rel_err": rep_rel,
                                     "worst_update_share": rep_worst},
               "deterministic": "torch.use_deterministic_algorithms("
                                "warn_only=True), cudnn.deterministic",
               "nondeterministic_ops": sorted(set(nondet).union(
                   *(r["check_nondeterministic_ops"] for r in rows))),
               "ranks_bit_equal": check_equal,
               "tolerance": {"loss_rtol": LOSS_RTOL,
                             "update_l2_rtol": UPDATE_L2_RTOL,
                             "stats_rtol": STATS_RTOL}},
           "full_width": {
               "config": {"depth": 50, "input_size": TRAIN_SIZE,
                          "global_batch": batch, "per_rank": batch //
                          SHARDED_RANKS, "proposals": [1000, 512],
                          "bf16": True, "norm": "batch", "remat": True,
                          "steps": SHARDED_STEPS},
               "s_per_step_median_by_rank":
               [r["s_per_step_median"] for r in rows],
               "peak_gib_by_rank": [r["peak_gib"] for r in rows],
               "gradient_floats": rows[0]["gradient_floats"],
               "allreduce_ms_by_rank": [r["allreduce_ms"] for r in rows],
               "batch_norm_layers": sum(
                   k.endswith(".norm.mean") for k in trained),
               "loss_first": losses[0], "loss_last": losses[-1],
               "val_loss": rows[0]["val_loss"],
               "ranks_bit_equal": len(digests) == 1,
               "checkpoint_is_the_ranks_state": ckpt_equal,
               "one_process_batch_4_remat": {
                   "s_per_step_median": one["s_per_step_median"],
                   "peak_gib": one["peak_gib"]},
               "ranks_wall_s": ranks_wall},
           "serve": {"tiles": written, "files": len(files),
                     "batches": batches, "crowns": crowns,
                     "launches": counts},
           "k1_launches": counts["k1"],
           "seconds": time.time() - t_phase}
    emit(row)
    if [r["rank"] for r in rows] != list(range(SHARDED_RANKS)) or \
            any(r["ranks"] != SHARDED_RANKS for r in rows):
        fail(f"train_sharded: ranks {[(r['rank'], r['ranks']) for r in rows]}")
    if held > LOSS_RTOL or worst[0][1] > 1.0:
        fail(f"train_sharded: two ranks disagree with one process: losses "
             f"{loss_rel}, worst updates {worst}")
    if not check_equal or len(digests) != 1:
        fail("train_sharded: the ranks' state dicts differ")
    if any(r["check_losses"] != rows[0]["check_losses"] or
           r["losses"] != losses for r in rows):
        fail("train_sharded: the ranks report different losses")
    if not all(math.isfinite(v) for v in losses + rows[0]["val_loss"]) or \
            len(losses) != SHARDED_STEPS or not rows[0]["val_loss"]:
        fail(f"train_sharded: losses {losses}, validation "
             f"{rows[0]['val_loss']}")
    if not losses[-1] < losses[0]:
        fail(f"train_sharded: the loss did not fall: {losses}")
    if not ckpt_equal:
        fail("train_sharded: rank 0's checkpoint is not the ranks' state")
    if written != 16 or len(files) != 16:
        fail(f"train_sharded: served {written} tiles, {len(files)} files")
    if counts != {"k1": 2 * batches, "k5": 0, "k6": 0}:
        fail(f"train_sharded: launches {counts} for {batches} batches "
             f"(expected K1 twice per batch and no other)")
    state["train_sharded"] = row


# --- phase 8: eval of the served crowns ---------------------------------------

EVAL_IOU = 0.5
EVAL_CONFIDENCE = 0.3
EVAL_SWEEP = (0.3, 0.5, 0.7, 0.9)        # confidences of confidence_sweep
EVAL_GRID = ((0.3, 0.5), (0.5, 0.7))     # IoU x confidence of evaluate_grid


def disc_rings(discs):
    """The synthetic raster's crown discs (row, col, radius px) as 32-gons
    in map coordinates."""
    t = np.linspace(0.0, 2 * np.pi, 32, endpoint=False)
    return [np.stack([412000.0 + (cx + rad * np.cos(t)) * 0.2,
                      5318000.0 - (cy + rad * np.sin(t)) * 0.2], axis=1)
            for cy, cx, rad in discs]


def _timed_call(fn, *args, **kw):
    t0 = time.time()
    out = fn(*args, **kw)
    return out, time.time() - t0


def _all_finite(rows) -> bool:
    return all(math.isfinite(v) for r in rows for v in r.values()
               if isinstance(v, (int, float)))


def _port_cli(*argv, timeout=600):
    """``python -m treedetection_tpu_torch.cli ARGV`` from the checkout ->
    its standard output; fails on a non-zero exit."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "treedetection_tpu_torch.cli", *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        fail(f"treedetection-torch {argv[0]} exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    return proc.stdout


def phase_eval(state, workdir: Path):
    """Score the crowns the card served: the predictor phase's pass of the
    shipped checkpoint and the train phase's pass of the 30-step one, each
    stitched into a GPKG, against the predictor raster's own disc polygons
    (seed 0; the trainer saw seed 1's raster).  No quality claim."""
    from treedetection_tpu_torch.eval import confidence_sweep, evaluate_grid
    from treedetection_tpu_torch.eval.validation import evaluate_gpkg_pair
    from treedetection_tpu_torch.stitching import stitch_image
    from treedetection_tpu_torch.vector import read_gpkg, write_gpkg
    t_phase = time.time()
    edir = workdir / "eval"
    edir.mkdir()
    gts = disc_rings(state["discs"])
    gt = edir / "discs.gpkg"
    write_gpkg(str(gt), gts, [{"Confidence_score": 1.0}] * len(gts))
    # checkpoint -> (served tile files, the phase whose K1 launches served
    # them); this phase itself launches no kernel
    served = {"shipped": (state["pred_timed_dir"], "predictor"),
              "trained_30_steps": (state["pred_trained_dir"], "train")}
    rows, pairs = {}, {}
    for name, (pred_dir, phase) in served.items():
        gpkg = edir / f"{name}.gpkg"
        crowns, stitch_s = _timed_call(stitch_image, str(pred_dir), str(gpkg))
        pair, pair_s = _timed_call(evaluate_gpkg_pair, str(gpkg), str(gt),
                                   EVAL_IOU, EVAL_CONFIDENCE)
        geoms, props, _ = read_gpkg(str(gpkg))
        preds = [np.asarray(g[0][0]) for g in geoms if g and g[0]]
        scores = [float(p.get("Confidence_score", 0.0))
                  for g, p in zip(geoms, props) if g and g[0]]
        (best, sweep), sweep_s = _timed_call(
            confidence_sweep, preds, scores, gts, EVAL_IOU, EVAL_SWEEP)
        grid, grid_s = _timed_call(evaluate_grid, preds, scores, gts,
                                   *EVAL_GRID)
        rows[name] = {
            "crowns": crowns, "served_in_phase": phase,
            "precision": pair["precision"], "recall": pair["recall"],
            "f1": pair["f1"], "mean_iou": pair["mean_iou"],
            "tp_fp_fn": [pair["tp"], pair["fp"], pair["fn"]],
            "best_confidence": best,
            "best_f1": max(r["f1"] for r in sweep),
            "sweep_f1": {str(r["confidence_threshold"]): r["f1"]
                         for r in sweep},
            "grid_f1": {f"{r['iou_threshold']}/{r['confidence_threshold']}":
                        r["f1"] for r in grid},
            "seconds": {"stitch_image": stitch_s,
                        "evaluate_gpkg_pair": pair_s,
                        "confidence_sweep": sweep_s,
                        "evaluate_grid": grid_s}}
        pairs[name] = pair
        if not _all_finite([pair, *sweep, *grid]):
            fail(f"eval: a non-finite metric for {name}: {pair}")
        if crowns == 0:
            fail(f"eval: the {name} pass stitched no crowns")
    t0 = time.time()
    cli = json.loads(_port_cli("eval", str(edir / "shipped.gpkg"), str(gt),
                               "--iou", str(EVAL_IOU),
                               "--confidence", str(EVAL_CONFIDENCE)))
    cli_s = time.time() - t0
    cli_equal = cli == pairs["shipped"]
    row = {"phase": "eval", "ground_truth_discs": len(gts),
           "iou": EVAL_IOU, "confidence": EVAL_CONFIDENCE,
           "sweep": list(EVAL_SWEEP), "grid": [list(g) for g in EVAL_GRID],
           **rows, "cli_equals_call": cli_equal, "cli_s": cli_s,
           "seconds": time.time() - t_phase}
    emit(row)
    if not cli_equal:
        fail(f"eval: the CLI printed {cli}, the call returned "
             f"{pairs['shipped']}")
    state["eval"] = row


# --- phase 9: autolabels from an nDSM on the card ------------------------------

NDSM_PX = 1000            # 1 km^2 at 1 m, the reference sample's size
CARD = "cuda"
CARD_FLAGS = ()           # the voronoi and autolabel subcommands' --device
SEEDS_TIMING_TILES = 5    # find_crown_seeds timed on 5x5 such blocks
SEEDS_TIMING_RUNS = 5


def synthetic_ndsm(side: int, seed: int = 2):
    """(side, side) float32 heights at 1 m: flat ground, seeded Gaussian
    crowns of 2-12 m radius and 5-30 m height (about 25 per hectare), and
    a few flat roof plateaus 4-12 m high."""
    rng = np.random.default_rng(seed)
    h = np.zeros((side, side), np.float32)
    for _ in range(side * side // 400):
        cy, cx = rng.uniform(0, side, 2)
        rad, peak = rng.uniform(2, 12), rng.uniform(5, 30)
        r = int(rad * 1.5) + 1
        y0, y1 = max(int(cy) - r, 0), min(int(cy) + r + 1, side)
        x0, x1 = max(int(cx) - r, 0), min(int(cx) + r + 1, side)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        bump = peak * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                             / (2 * (rad / 2) ** 2))
        h[y0:y1, x0:x1] = np.maximum(h[y0:y1, x0:x1], bump)
    for _ in range(max(side // 150, 1)):
        y0, x0 = rng.integers(0, side - 40, 2)
        dy, dx = rng.integers(10, 40, 2)
        h[y0:y0 + dy, x0:x0 + dx] = rng.uniform(4, 12)
    return h


def _layer(path):
    from treedetection_tpu_torch.vector import read_gpkg
    geoms, props, _ = read_gpkg(str(path))
    return [np.asarray(g[0][0]) for g in geoms], props


def _same_layer(a, b) -> bool:
    (ga, pa), (gb, pb) = _layer(a), _layer(b)
    return len(ga) == len(gb) and pa == pb and all(
        np.array_equal(x, y) for x, y in zip(ga, gb))


def _seeds_ms(find_crown_seeds, height):
    import torch
    for _ in range(2):                                     # warm-up
        find_crown_seeds(height)
    times = []
    for _ in range(SEEDS_TIMING_RUNS):
        if height.is_cuda:
            torch.cuda.synchronize()
        t0 = time.time()
        find_crown_seeds(height)
        if height.is_cuda:
            torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
    return statistics.median(times)


def phase_trace(state):
    """``tools/trace_check.py`` over the three pooler layouts in a child
    process (it switches the sync debug mode and wraps the profiler's
    classes): each of its lines without the per-site detail, and a failure
    on its verdict."""
    cmd = [sys.executable, str(REPO / "tools" / "trace_check.py"),
           "--parts", "syncs,off", "--layouts", "flat,levels,resident"]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    verdict = None
    for text in proc.stdout.splitlines():
        if not text.startswith("{"):
            continue
        line = json.loads(text)
        if line.get("part") == "verdict":
            verdict = line
        line.pop("sites", None)
        line.pop("record", None)
        emit({"phase": "trace", **line})
    emit({"phase": "trace", "seconds": round(time.time() - t0, 3),
          "rc": proc.returncode})
    if proc.returncode != 0 or verdict is None or not verdict["ok"]:
        fail(f"trace_check: rc {proc.returncode}, "
             f"{verdict['problems'] if verdict else proc.stderr[-2000:]}")
    # the ViTDet cell: the attention kernel once a block, no sync in the
    # backbone
    cmd = [sys.executable, str(REPO / "tools" / "trace_check.py"),
           "--cell", "vitdet_l_tile_stream", "--parts", "syncs,off",
           "--layouts", "flat"]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    verdict = None
    for text in proc.stdout.splitlines():
        if not text.startswith("{"):
            continue
        line = json.loads(text)
        if line.get("part") == "verdict":
            verdict = line
        line.pop("sites", None)
        line.pop("record", None)
        emit({"phase": "trace", "cell": "vitdet_l_tile_stream", **line})
    emit({"phase": "trace", "cell": "vitdet_l_tile_stream",
          "seconds": round(time.time() - t0, 3), "rc": proc.returncode})
    if proc.returncode != 0 or verdict is None or not verdict["ok"]:
        fail(f"trace_check (vitdet): rc {proc.returncode}, "
             f"{verdict['problems'] if verdict else proc.stderr[-2000:]}")


def phase_autolabel(state, workdir: Path):
    """Voronoi and region-grow labels from a synthetic 1 km^2 nDSM on the
    card with TF32 at torch's defaults, held against the CPU; the seed
    search timed on a 25 km^2 block; the Cambridge flow, the NDVI debug
    raster, mask pasting and class-aware NMS card against CPU; the voronoi
    and autolabel subcommands."""
    import shutil
    import torch
    from treedetection_tpu_torch.autolabel import (
        autolabel_and_evaluate, generate_region_grow_labels,
        generate_voronoi_labels)
    from treedetection_tpu_torch.autolabel.voronoi import find_crown_seeds
    from treedetection_tpu_torch.geo import Affine, GeoTiff, write_geotiff
    from treedetection_tpu_torch.ops.masks import paste_masks_in_image
    from treedetection_tpu_torch.ops.nms import batched_nms
    from treedetection_tpu_torch.utils.ndvi_debug import write_ndvi_debug
    from treedetection_tpu_torch.vector import write_gpkg
    t_phase = time.time()
    adir = workdir / "autolabel"
    adir.mkdir()
    height = synthetic_ndsm(NDSM_PX)
    ndsm = adir / "ndsm.tif"
    write_geotiff(str(ndsm), height, Affine.from_origin(412000.0, 5318000.0,
                                                        1.0, 1.0), crs=25832)

    # 1. labels on the card with TF32 at torch's defaults, then on the CPU
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = state["tf32_default"]
    try:
        labels, seeds = {}, {}
        for dev in (CARD, "cpu"):
            t = torch.from_numpy(height).to(dev)
            smooth, mask = find_crown_seeds(t)
            seeds[dev] = (smooth.cpu().numpy(), mask.cpu().numpy())
            for gen, fn in (("voronoi", generate_voronoi_labels),
                            ("region_grow", generate_region_grow_labels)):
                out = adir / f"{gen}_{dev}.gpkg"
                n, s = _timed_call(fn, str(ndsm), str(out), device=dev)
                labels[(gen, dev)] = {"crowns": n, "s": s, "path": out}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    (s_gpu, m_gpu), (s_cpu, m_cpu) = seeds[CARD], seeds["cpu"]
    smooth_err = float(np.abs(s_gpu - s_cpu).max())
    same_layers = {gen: _same_layer(labels[(gen, CARD)]["path"],
                                    labels[(gen, "cpu")]["path"])
                   for gen in ("voronoi", "region_grow")}

    # 2. the seed search alone on a 25 km^2 block, card against CPU
    big = np.tile(height, (SEEDS_TIMING_TILES, SEEDS_TIMING_TILES))
    seeds_ms = {dev: _seeds_ms(find_crown_seeds,
                               torch.from_numpy(big).to(dev))
                for dev in (CARD, "cpu")}

    # 3. the Cambridge flow on the predictor raster and its discs, in-process
    # and through the autolabel subcommand
    for sub in ("img", "ann"):
        (adir / sub).mkdir()
    img = adir / "img" / state["tif"].name
    shutil.copy(state["tif"], img)
    rings = disc_rings(state["discs"])
    ann = adir / "ann" / f"{img.stem}.gpkg"
    write_gpkg(str(ann), rings, [{} for _ in rings], srs_id=25832)
    cam, cam_s = _timed_call(autolabel_and_evaluate, str(img), str(ann),
                             out_gpkg=str(adir / "cambridge.gpkg"))
    cli_rows = json.loads(_port_cli("autolabel", str(adir / "img"),
                                    str(adir / "ann"), str(adir / "cli"),
                                    *CARD_FLAGS))
    cli_voronoi = _port_cli("voronoi", str(ndsm), str(adir / "cli.gpkg"),
                            *CARD_FLAGS)

    # 4. the NDVI debug raster on the card against float64 numpy
    tif, png = write_ndvi_debug(str(state["tif"]), str(adir / "ndvi"),
                                plot=False, device=CARD)
    with GeoTiff(str(state["tif"])) as g:
        rgbi = g.read().astype(np.float64)
    with GeoTiff(tif) as g:
        ndvi = g.read()[..., 0]
    r, nir = rgbi[..., 0] / 255.0, rgbi[..., 3] / 255.0
    ndvi_err = float(np.abs(ndvi - (nir - r) / (nir + r + 1e-7)).max())

    # 5. mask pasting (one batch's 100 detections at 1024^2) and class-aware
    # NMS (1000 boxes, 3 classes), card against CPU
    rng = np.random.default_rng(3)
    masks = torch.from_numpy(rng.uniform(0, 1, (100, 28, 28)).astype(
        np.float32))
    xy = rng.uniform(-20, 1000, (100, 2))
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(4, 200, (100, 2))], 1).astype(np.float32))
    pasted = {dev: paste_masks_in_image(masks.to(dev), boxes.to(dev),
                                        1024, 1024).cpu()
              for dev in (CARD, "cpu")}
    near = paste_masks_in_image(masks, boxes, 1024, 1024, 0.5 - 1e-6) != \
        paste_masks_in_image(masks, boxes, 1024, 1024, 0.5 + 1e-6)
    paste_diff = int((pasted[CARD] != pasted["cpu"])[~near].sum())
    c = rng.uniform(0, 1024, (1000, 2))
    nboxes = torch.from_numpy(np.concatenate(
        [c, c + rng.uniform(8, 120, (1000, 2))], 1).astype(np.float32))
    nscores = torch.from_numpy(rng.uniform(0, 1, 1000).astype(np.float32))
    idxs = torch.from_numpy(rng.integers(0, 3, 1000))
    keep = {dev: batched_nms(nboxes.to(dev), nscores.to(dev), idxs.to(dev),
                             0.5).cpu() for dev in (CARD, "cpu")}

    row = {"phase": "autolabel", "ndsm_px": NDSM_PX,
           "tf32_during_card_runs": dict(zip(
               ("matmul", "cudnn"), state["tf32_default"])),
           "seeds": int(m_cpu.sum()),
           "seed_masks_equal": bool(np.array_equal(m_gpu, m_cpu)),
           "smooth_max_abs_err": smooth_err,
           "smooth_rel_to_peak": smooth_err / float(np.abs(s_cpu).max()),
           **{f"{gen}_{dev}": {"crowns": v["crowns"], "s": v["s"]}
              for (gen, dev), v in labels.items()},
           "layers_equal": same_layers,
           "find_crown_seeds_ms_5000px": seeds_ms,
           "cambridge": {k: cam[k] for k in (
               "n_annotations", "n_crowns", "precision", "recall", "f1",
               "mean_iou", "flags")}, "cambridge_s": cam_s,
           "autolabel_cli_equals_call": cli_rows == [cam],
           "voronoi_cli": cli_voronoi.strip(),
           "ndvi_max_abs_err_vs_float64": ndvi_err,
           "paste_masks": {"pixels": int(near.numel()),
                           "near_threshold": int(near.sum()),
                           "mismatches_elsewhere": paste_diff},
           "batched_nms": {"kept": int(keep["cpu"].sum()),
                           "keep_equal": bool(torch.equal(keep[CARD],
                                                          keep["cpu"]))},
           "seconds": time.time() - t_phase}
    emit(row)
    print(gpu_line(), flush=True)
    n_vor = labels[("voronoi", CARD)]["crowns"]
    if not row["seed_masks_equal"] or row["smooth_rel_to_peak"] > 1e-6:
        fail(f"autolabel: the card's seeds differ from the CPU's "
             f"(smooth {smooth_err})")
    if not all(same_layers.values()) or any(
            labels[(g, CARD)]["crowns"] != labels[(g, "cpu")]["crowns"]
            or labels[(g, CARD)]["crowns"] == 0
            for g in ("voronoi", "region_grow")):
        fail(f"autolabel: the card's labels differ from the CPU's: {row}")
    if cli_voronoi.strip() != f"{n_vor} crowns -> {adir / 'cli.gpkg'}" or \
            not row["autolabel_cli_equals_call"]:
        fail(f"autolabel: the subcommands disagree with the calls: "
             f"{cli_voronoi!r}, {cli_rows} vs {cam}")
    if cam["n_crowns"] != len(rings) or not math.isfinite(cam["f1"]):
        fail(f"autolabel: the Cambridge flow gave {cam}")
    if ndvi_err > 1e-6 or png is not None:
        fail(f"autolabel: NDVI off float64 numpy by {ndvi_err}")
    if paste_diff or not row["batched_nms"]["keep_equal"]:
        fail(f"autolabel: pasting or NMS differ card against CPU: {row}")
    state["autolabel"] = row


# --- phase 10: summary ----------------------------------------------------------

ROI_KERNELS = {   # key -> (number, wrapper, source, the TPU kernel's line)
    "k1": ("K1", "roi_pool_patches_flat", "roi_pool_flat.cu", 172),
    "k5": ("K5", "roi_pool_patches", "roi_pool_levels.cu", 37),
    "k6": ("K6", "roi_pool_resident", "roi_pool_resident.cu", 281)}
NO_LIBRARY = "no single PyTorch call computes this function"


def _roi_entry(key, calls, launches, launches_by_path, note):
    """One ROI pooler's entry: ``calls`` maps a label to the (pool, dtype)
    rows of the kernel phase; the headline numbers are the bf16 box pool plus
    the bf16 mask pool of the first label (one batch of the example
    config)."""
    number, wrapper, source, line = ROI_KERNELS[key]
    rows = next(iter(calls.values()))
    box, mask = rows[("box", "bfloat16")], rows[("mask", "bfloat16")]
    t_bytes = (box["bytes"] + mask["bytes"]) / H100_BYTES_PER_S * 1e3
    t_ops = (box["flops"] + mask["flops"]) / PEAK_FLOPS["bfloat16"] * 1e3
    by_call = {}
    for label, group in calls.items():
        for (pool, dname), r in group.items():
            by_call[f"{label}{pool}/{dname}"] = {key_: r[key_] for key_ in (
                "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
    return {
        "name": wrapper, "number": number, "route": "cuda",
        "source": f"treedetection_tpu_torch/csrc/{source}",
        "replaces": f"treedetection_tpu/ops/pallas/roi_align_kernel.py:{line}",
        "launches": launches, "launches_by_path": launches_by_path,
        "max_abs_err": max(r["max_abs_err"] for group in calls.values()
                           for r in group.values()),
        "ms": box["ms"] + mask["ms"],
        "plain_ms": box["plain_ms"] + mask["plain_ms"],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "library_note": NO_LIBRARY,
        "per_batch_of": "box pool (N=5120, R=7) + mask pool (N=1000, R=14), "
                        "bf16, C=256, 1024^2 input, batch 10" + note,
        "by_call": by_call}


def kernels_line(state):
    roi, pipe = state["roi"], state["pipeline"]
    two, res = state["two_model"], state["resident"]
    multi = state["multihost"]
    picked = roi["k6_c1"][("box", "bfloat16")]["c_split_the_launcher_picks"]
    k6_calls = {f"c_split={cs}/": roi[f"k6_c{cs}"]
                for cs in sorted((1, 2), key=lambda cs: cs != picked)}
    kernels = [
        _roi_entry("k1", {"": roi["k1"]}, pipe["launches"]["k1"],
                   {"pipeline": pipe["launches"]["k1"],
                    "pipeline_multihost": multi["launches"]["k1"],
                    "predictor": state["predictor"]["k1_launches"],
                    "predictor_split":
                    state["predictor_split"]["launches"]["k1"],
                    "pipeline_two_model": two["launches"]["k1"],
                    "bench": state["bench"]["launches"]["k1"],
                    "train": state["train"]["k1_launches"],
                    "train_sharded": state["train_sharded"]["k1_launches"]},
                   ""),
        _roi_entry("k5", {"": roi["k5"]}, two["launches"]["k5"],
                   {"pipeline_two_model": two["launches"]["k5"],
                    "predictor_levels":
                    state["predictor_levels"]["launches"]["k5"],
                    "pipeline": pipe["launches"]["k5"]},
                   "; on the path under TD_ROI_FLAT=0"),
        _roi_entry("k6", k6_calls, res["launches"]["k6"],
                   {"predictor_resident": res["launches"]["k6"],
                    "pipeline": pipe["launches"]["k6"]},
                   f"; on the path under TD_ROI_RESIDENT=1; headline numbers "
                   f"at c_split={picked}, which the launcher picks in bf16")]
    for entry, key in zip(kernels, ("k1", "k5", "k6")):
        entry["device_function"] = {"bfloat16": "pool_box_bf16",
                                    "float32": "pool_box"}
        entry["ptxas_bf16"] = state.get("bf16_ptxas", {}).get(key)
    for dname, suffix in (("bfloat16", "bf16"), ("float32", "f32")):
        kernels[-1][f"ms_by_chunk_{suffix}"] = {
            pool: v for (pool, d), v in roi["k6_by_chunk"].items()
            if d == dname}
    dev_branch = state["pipeline_devicebranch"]["launches"]
    source = "treedetection_tpu_torch/csrc/pairwise_boxes.cu"
    for mode, (number, wrapper, line) in PAIR_KERNELS.items():
        r = state["pairwise"][mode]
        entry = {
            "name": wrapper, "number": number, "route": "cuda",
            "source": source,
            "replaces": f"treedetection_tpu/ops/pallas/iou_kernel.py:{line}",
            "launches": pipe["launches"][mode],
            "launches_by_path": {"pipeline": pipe["launches"][mode],
                                 "pipeline_devicebranch": dev_branch[mode],
                                 "pipeline_multihost":
                                 multi["launches"][mode]},
            "max_abs_err": 0.0 if r["mismatches"] == 0
            and not r.get("bits_mismatches") else 1.0,
            "mismatches": r["mismatches"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "kernel_ms": r["kernel_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "library_note": NO_LIBRARY,
            "per_call_of": f"one row block, {r['shape'][0]} rows x "
                           f"{r['shape'][1]} columns, float32 in, "
                           + ("uint8 mask out" if mode == "iou" else
                              "the relation bit-packed out")}
        form = "uint8" if mode == "iou" else "bits"
        entry["design"] = f"relation_kernel<{mode}, {form}>"
        entry["ptxas"] = state.get("relation_ptxas", {}).get(f"{mode}/{form}")
        if mode == "iou":
            entry["note"] = ("no caller in either package: launched only by "
                             "the kernel phase, where it is held against "
                             "its plain version")
        else:
            entry["bits_mismatches"] = r["bits_mismatches"]
            entry["uint8_form"] = dict(
                r["uint8"], name=MASK_WRAPPERS[mode],
                ptxas=state.get("relation_ptxas", {}).get(f"{mode}/uint8"))
            entry["block_path"] = dict(r["block_path"],
                                       paths_equal=r["paths_equal"])
        kernels.append(entry)
    pairs = {mode: state["pairwise"][mode]["relation_pairs"]
             for mode in ("dedupe", "containment")}
    kernels.append({
        "name": "relation_pairs", "number": "K2/K3 compaction",
        "route": "cuda", "source": source,
        "replaces": "treedetection_tpu/postprocessing.py:234",
        "replaces_note": "no TPU kernel: the JAX package unpacks each row "
                         "block on the host and takes np.nonzero",
        "launches": pipe["launches"]["pairs"],
        "launches_by_path": {"pipeline": pipe["launches"]["pairs"],
                             "pipeline_devicebranch": dev_branch["pairs"],
                             "pipeline_multihost": multi["launches"]["pairs"]},
        "max_abs_err": 0.0 if all(state["pairwise"][m]["pairs_equal"]
                                  for m in pairs) else 1.0,
        "ms": pairs["dedupe"]["ms"], "plain_ms": pairs["dedupe"]["plain_ms"],
        "kernel_ms": pairs["dedupe"]["kernel_ms"],
        "bound_ms": pairs["dedupe"]["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "library_note": NO_LIBRARY,
        "per_call_of": "K2's production row block (8192 x 32768, bit-packed) "
                       "to its pairs",
        "by_mode": pairs})
    relpos = state.get("relpos")
    if relpos:
        per = RELPOS_SHAPES["blocks"]
        kernels.append({
            "name": "relpos_attention", "number": "A", "route": "cuda",
            "source": "treedetection_tpu_torch/csrc/relpos_attention.cu",
            "replaces": None,
            "replaces_note": "no TPU kernel: ViTDet's windowed and global "
                             "attention with decomposed relative positions "
                             "(the JAX package has no ViT)",
            "ms": sum(per[k] * relpos[k]["ms"] for k in per),
            "alone_ms": (sum(per[k] * relpos[k]["alone_ms"] for k in per)
                         if all(relpos[k]["alone_ms"] for k in per)
                         else None),
            "bound_ms": sum(per[k] * relpos[k]["bound_ms"] for k in per),
            "max_abs_err": max(r["max_abs_err"] for r in relpos.values()),
            "per_forward_of": "20 windowed + 4 global launches, batch 10, "
                              "64 x 64 tokens, 16 heads of 64, bf16",
            "by_kind": relpos, "edges": state.get("relpos_edges"),
            "ptxas": state.get("relpos_ptxas")})
    return {"kernels": kernels}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--profile", type=Path, default=None, metavar="DIR",
                    help="after the predictor phase, profile one more pass "
                         "and write its kernel table and trace to DIR; the "
                         "bench phase writes its profiled passes' traces "
                         "there too")
    ap.add_argument("--multihost-child", type=Path, default=None,
                    metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--train-child", type=Path, default=None,
                    metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--warmup-child", nargs=2, default=None,
                    metavar=("ROOT", "MODE"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    phases = args.phases.split(",")
    if set(phases) - set(PHASES):
        fail(f"unknown phases {sorted(set(phases) - set(PHASES))}")
    if "pipeline_two_model" in phases and "predictor" not in phases:
        fail("the pipeline_two_model phase reruns the predictor phase's "
             "raster: name both")
    if "pipeline_multihost" in phases and "pipeline" not in phases:
        fail("the pipeline_multihost phase reruns the pipeline phase's "
             "sheets: name both")
    if "warmup" in phases and "pipeline" not in phases:
        fail("the warmup phase reruns the pipeline phase's sheets: name "
             "both")
    if "train" in phases and "predictor" not in phases:
        fail("the train phase serves on the predictor phase's raster: name "
             "both")
    if "train_sharded" in phases and "train" not in phases:
        fail("the train_sharded phase trains on the train phase's shards: "
             "name both")
    if "eval" in phases and not {"predictor", "train"} <= set(phases):
        fail("the eval phase scores the predictor and train phases' served "
             "crowns: name all three")
    if "autolabel" in phases and "predictor" not in phases:
        fail("the autolabel phase reruns the predictor phase's raster: name "
             "both")
    if not (REPO / "treedetection_tpu_torch" / "__init__.py").is_file():
        fail("the treedetection_tpu_torch package is not beside this script")
    if args.warmup_child is None:   # a cold warm-up child imports a copy
        sys.path.insert(0, str(REPO))
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    state = {"tf32_default": (torch.backends.cuda.matmul.allow_tf32,
                              torch.backends.cudnn.allow_tf32)}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.multihost_child is not None:
        multihost_child(args.multihost_child)
        return
    if args.train_child is not None:
        train_child(args.train_child)
        return
    if args.warmup_child is not None:
        warmup_child(Path(args.warmup_child[0]), args.warmup_child[1])
        return
    t_start = time.time()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        if "build" in phases:
            phase_build(state)
        if "kernel" in phases:
            phase_kernel(state)
            phase_kernel_prep(state)
            phase_kernel_pairwise(state)
            phase_kernel_relpos(state)
        if "predictor" in phases:
            phase_predictor(state, work)
            phase_predictor_levels(state, work)
            phase_predictor_split(state, work)
            if args.profile is not None:
                phase_profile(state, work, args.profile)
        if "model" in phases:
            phase_model(state, work)
        if "pipeline" in phases:
            phase_pipeline(state, work)
        if "pipeline_multihost" in phases:
            phase_pipeline_multihost(state, work)
        if "warmup" in phases:
            phase_warmup(state, work)
        if "pipeline_two_model" in phases:
            phase_pipeline_two_model(state, work)
        if "bench" in phases:
            phase_bench(state, work, args.profile)
        if "train" in phases:
            phase_train(state, work)
        if "train_sharded" in phases:
            phase_train_sharded(state, work)
        if "eval" in phases:
            phase_eval(state, work)
        if "autolabel" in phases:
            phase_autolabel(state, work)
        if "trace" in phases:
            phase_trace(state)
    if set(phases) == set(PHASES):
        emit(kernels_line(state))
    emit({"phase": "done", "seconds": round(time.time() - t_start, 3)})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
