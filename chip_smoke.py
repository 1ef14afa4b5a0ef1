#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Phases (each prints JSON lines; any failure exits non-zero).  ``--phases``
takes a comma-separated subset of build,kernel,predictor,model,pipeline:

1. build     — compile the port's native libraries from the sources in the
               checkout (nvcc for the two CUDA kernel sources, g++ for the
               host helpers), all compilers started together; prints each
               kernel's ``ptxas`` lines.
2. kernel    — K1 (the flat ROIAlign patch pooler) against its plain PyTorch
               version at production shapes (box pool N=5120 R=7, mask pool
               N=1000 R=14, fcat for 1024^2 input at batch 10, C=256), in
               float32 with TF32 off and in bfloat16; K2/K3/K4 (the pairwise
               dedupe, containment and IoU masks) against their plain versions
               with EXACT equality at one production row block (8192 rows x
               32768 columns), at ragged and square shapes, and on
               adversarial rows; medians of CUDA event timings, and the bound
               computed from this run's inputs.
3. predictor — the port's Predictor (R50-FPN, 1024^2, batch 10, 512
               proposals, bf16) on a synthetic 1000x1000 px RGBI GeoTIFF
               tiled into 16 tiles: a first pass, then a timed pass with the
               kernel launch counts reset just before it and read just after.
4. model     — one batch's real proposals and detections pooled through K1
               and the plain version, and the float32 forward's kept sets with
               each pooler (passed explicitly).
5. pipeline  — ``process_files`` end to end with a dict config and
               ``TD_PAIRS_DEVICE=1``: a synthetic 1 km^2 sheet (5000x5000 px
               RGBI at 0.2 m, 400 tiles) with its 1 m nDSM, plus an adjacent
               200 m sheet so that a seam strip is cut, tiled and predicted;
               checks the processed GPKG, the K1/K2/K3 launch counts, that
               the host-grid branch gives the same crowns, and that a second
               call predicts nothing.
6. kernels   — the per-kernel summary line, then the card's name and power
               limit, then the final status line.

Imports nothing of JAX.  Exits non-zero without a result when CUDA is not
available or the port's package is not beside this script.
"""

from __future__ import annotations

import argparse
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
PHASES = ("build", "kernel", "predictor", "model", "pipeline")
PAIRWISE_BLOCK_ROWS, PAIRWISE_COLS = 8192, 32768   # one production row block
# float32 operations per (row, column) pair, counted from the arithmetic:
# intersection 9 (2 min, 2 max, 2 sub, 2 clamp, 1 mul); IoU +5 (add, sub,
# compare, divide, compare); containment +3 (compare, divide, compare);
# dedupe = IoU + 7 (sub, abs, 2 max, divide, compare, and)
PAIR_OPS = {"iou": 14, "containment": 12, "dedupe": 21}
PAIR_KERNELS = {   # mode -> (kernel number, wrapper, the TPU kernel's line)
    "dedupe": ("K2", "pairwise_dedupe_mask", 64),
    "containment": ("K3", "pairwise_containment_mask", 57),
    "iou": ("K4", "pairwise_iou_mask", 49)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


# --- phase 1: build ----------------------------------------------------------

def phase_build():
    from treedetection_tpu_torch import native
    from treedetection_tpu_torch.ops.kernels import pairwise as k234
    from treedetection_tpu_torch.ops.kernels import roi_align as k1
    results, errors = {}, {}

    def run(name, fn):
        t0 = time.time()
        try:
            results[name] = (fn(), time.time() - t0)
        except Exception as exc:  # reported below; the phase fails
            errors[name] = repr(exc)

    t0 = time.time()
    threads = [threading.Thread(target=run, args=(n, f)) for n, f in
               (("roi_pool_flat", k1.build), ("pairwise_boxes", k234.build),
                ("td_native", native.build))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        fail(f"build: {errors}")
    ptxas = {}
    for name in ("roi_pool_flat", "pairwise_boxes"):
        log = results[name][0].with_suffix(".log")
        ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                       if "registers" in ln or "spill" in ln or "smem" in ln]
    emit({"phase": "build", "seconds": round(time.time() - t0, 3),
          "each_s": {k: round(v[1], 3) for k, v in results.items()},
          "ptxas": ptxas})


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


def _synthetic_boxes(rng, b, n, img=1024.0):
    """Crown-like boxes: 16-200 px, aspect up to 2, a few elongated."""
    c = rng.uniform(0, img, (b, n, 2))
    s = rng.uniform(16, 200, (b, n, 1))
    asp = rng.uniform(0.5, 2.0, (b, n, 1))
    wh = s * [1.0, 1.0] * (asp ** [0.5, -0.5])
    out = np.concatenate([c - wh / 2, c + wh / 2], axis=-1)
    return np.clip(out, 0, img).astype(np.float32)


def k1_bound(inputs, resolution, dtype_name):
    """Least time the card could take: the larger of the bytes the function
    must move (touched part of fcat, the index and hat inputs, the output)
    over HBM bandwidth and its FLOPs over the peak for the type."""
    import torch
    p = inputs
    n, c = p.rows.shape[0], p.kcat.shape[-1]
    patch, cpatch = p.ay.shape[-1], p.ax.shape[-1]
    touched = torch.zeros(p.kcat.shape[:2], dtype=torch.bool,
                          device=p.kcat.device)
    ry = p.rows.long()[:, None] + torch.arange(patch, device=touched.device)
    cx = p.cols.long()[:, None] + torch.arange(cpatch, device=touched.device)
    for s in range(0, n, 1024):
        touched[ry[s:s + 1024, :, None], cx[s:s + 1024, None, :]] = True
    item = p.kcat.element_size()
    nbytes = (int(touched.sum()) * c * item + 8 * n
              + 4 * (p.ay.numel() + p.ax.numel())
              + n * resolution * resolution * c * item)
    flops = 2 * n * c * (resolution * patch * cpatch
                         + resolution * resolution * cpatch)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def tolerance(ref, dtype_name):
    """-> (atol, rtol) for ``|got - ref| <= atol + rtol * |ref|``.

    float32: the two versions sum the same terms in different orders, about
    1e-6 of the output's peak, so atol 2e-5 of the peak.  bfloat16: both
    accumulate in float32 and round once to bf16, so they differ by at most
    one bf16 ulp (rtol 2^-7) plus the float32 order difference where the
    sum cancels to near zero (atol 1e-5 of the peak)."""
    peak = max(1.0, float(ref.float().abs().max())) if ref.numel() else 1.0
    if dtype_name == "float32":
        return 2e-5 * peak, 0.0
    return 1e-5 * peak, 2.0 ** -7


def check_close(got, ref, dtype_name):
    """-> (ok, max_abs_err, stated tolerance)"""
    atol, rtol = tolerance(ref, dtype_name)
    diff = (got.float() - ref.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    return ok, err, {"atol": atol, "rtol": rtol}


def phase_kernel(state):
    import torch
    from treedetection_tpu_torch.ops.kernels.roi_align import (
        roi_pool_patches_flat, roi_pool_patches_flat_reference)
    from treedetection_tpu_torch.ops.roi_align import flat_pool_inputs
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    b, c = 10, 256
    feats32 = [torch.from_numpy(rng.standard_normal(
        (b, 1024 // s, 1024 // s, c)).astype(np.float32)).to(dev)
        for s in (4, 8, 16, 32)]
    summary = state.setdefault("k1", {})
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        feats = [f.to(dtype) for f in feats32]
        for pool, n, r in (("box", 512, 7), ("mask", 100, 14)):
            boxes = torch.from_numpy(_synthetic_boxes(rng, b, n)).to(dev)
            p = flat_pool_inputs(feats, boxes, r, (4, 8, 16, 32))
            args = (p.kcat, p.rows, p.cols, p.ay, p.ax, r)
            got = roi_pool_patches_flat(*args)
            ref = roi_pool_patches_flat_reference(*args)
            torch.cuda.synchronize()
            ok, err, tol = check_close(got, ref, dname)
            if not ok or not torch.isfinite(got.float()).all():
                fail(f"kernel {pool} {dname}: max abs err {err} vs {tol}")
            ms = _timed_ms(lambda: roi_pool_patches_flat(*args))
            plain_ms = _timed_ms(
                lambda: roi_pool_patches_flat_reference(*args), 1, 3)
            bound = k1_bound(p, r, dname)
            row = {"phase": "kernel", "pool": pool, "dtype": dname,
                   "n": b * n, "resolution": r,
                   "fcat_shape": list(p.kcat.shape), "max_abs_err": err,
                   "tolerance": tol, "ms": ms, "plain_ms": plain_ms, **bound}
            emit(row)
            summary[(pool, dname)] = row
            del got, ref, p, args
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


def pair_bound(mode, r, n):
    """Least time the card could take for an (r, n) mask: the bytes it must
    move (both box arrays read once, the uint8 mask written once) over HBM
    bandwidth, or its float32 operations over the CUDA-core peak."""
    width = 5 if mode == "dedupe" else 4
    nbytes = 4 * width * (r + n) + r * n
    ops = PAIR_OPS[mode] * r * n
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS["float32"] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": ops}


def _pair_calls(pw, mode, b, a, rows, thr):
    """-> (kernel call, plain call) for one mode; ``rows`` is None (square)
    or a (start, stop) slice of the boxes."""
    import torch
    rb = None if rows is None else b[rows[0]:rows[1]].contiguous()
    ra = None if rows is None else a[rows[0]:rows[1]].contiguous()
    if mode == "iou":
        return (lambda: pw.pairwise_iou_mask(b, thr[0], rows=rb),
                lambda: pw.iou_mask_reference(b if rb is None else rb, b,
                                              thr[0]))
    if mode == "containment":
        def plain():
            out = pw.containment_mask_reference(b if rb is None else rb, b,
                                                thr[0])
            return out.fill_diagonal_(0) if rb is None else out
        return (lambda: pw.pairwise_containment_mask(b, thr[0], rows=rb),
                plain)
    b5 = torch.cat([b, a[:, None]], dim=1)
    a5 = b5 if rb is None else torch.cat([rb, ra[:, None]], dim=1)
    return (lambda: pw.pairwise_dedupe_mask(b, a, thr[0], thr[1], rows=rb,
                                            row_areas=ra),
            lambda: pw.dedupe_mask_reference(a5, b5, thr[0], thr[1]))


def phase_kernel_pairwise(state):
    import torch
    from treedetection_tpu_torch.ops.kernels import pairwise as pw
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    big = _crown_boxes(rng, PAIRWISE_COLS)
    small = _crown_boxes(rng, 1000)
    adv = _adversarial_boxes()
    groups = (   # name, (boxes, areas), rows, thresholds per mode, timed
        ("production_block", big, (0, PAIRWISE_BLOCK_ROWS), None, True),
        ("ragged_77x1000", small, (400, 477), None, False),
        ("square_1000", small, None, None, False),
        ("adversarial_t1.0", adv, None,
         {"iou": (0.5, 0), "containment": (1.0, 0), "dedupe": (0.5, 1e-6)},
         False),
        ("adversarial_t0.9", adv, (2, 9),
         {"iou": (0.9, 0), "containment": (0.9, 0), "dedupe": (0.9, 0.5)},
         False))
    default_thr = {"iou": (0.5, 0), "containment": (0.9, 0),
                   "dedupe": (0.5, 0.3)}
    summary = state.setdefault("pairwise", {})
    for name, (boxes, areas), rows, thr, timed in groups:
        b = torch.from_numpy(boxes).to(dev)
        a = torch.from_numpy(areas).to(dev)
        for mode in ("dedupe", "containment", "iou"):
            kernel, plain = _pair_calls(pw, mode, b, a, rows,
                                        (thr or default_thr)[mode])
            got, ref = kernel(), plain()
            torch.cuda.synchronize()
            if got.dtype != torch.uint8 or got.shape != ref.shape:
                fail(f"kernel {mode} {name}: {got.dtype} {tuple(got.shape)}")
            mismatches = int((got != ref).sum())
            row = {"phase": "kernel", "kernel": PAIR_KERNELS[mode][0],
                   "mode": mode, "group": name, "shape": list(got.shape),
                   "ones": int(ref.sum()), "mismatches": mismatches,
                   "tolerance": "exact equality of the uint8 masks"}
            del got, ref
            if timed:
                row["ms"] = _timed_ms(kernel)
                row["plain_ms"] = _timed_ms(plain, 1, 3)
                row.update(pair_bound(mode, *row["shape"]))
                summary[mode] = row
            emit(row)
            if mismatches:
                fail(f"kernel {mode} {name}: {mismatches} entries differ "
                     f"from the plain version")
            if name != "ragged_77x1000" and row["ones"] == 0:
                fail(f"kernel {mode} {name}: the relation is empty, the "
                     f"comparison is vacuous")
            torch.cuda.empty_cache()


# --- phase 3: the Predictor at full width ------------------------------------

def write_synthetic_raster(path: Path, seed: int = 0) -> None:
    """1000x1000 px RGBI at 0.2 m: dark crown-like discs of 2-8 m radius on
    a lighter ground, with noise."""
    from treedetection_tpu_torch.geo import Affine, write_geotiff
    rng = np.random.default_rng(seed)
    h = w = 1000
    img = np.empty((h, w, 4), dtype=np.float32)
    img[..., :3] = rng.normal([150, 160, 120], 12, (h, w, 3))
    img[..., 3] = rng.normal(110, 10, (h, w))
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(180):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        rad = rng.uniform(2.0, 8.0) / 0.2
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
    from treedetection_tpu_torch.ops.kernels import roi_align as k1
    from treedetection_tpu_torch.preprocessing import tile_single_file
    tif = workdir / "rgb" / "324125317.tif"
    tif.parent.mkdir(parents=True)
    write_synthetic_raster(tif)
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
    k1.launches = 0                       # just before the main path
    t0 = time.time()
    written = pred(str(tif), meta, str(out2))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = k1.launches                # just after
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    stats = dict(prediction.LAST_RUN_STATS)
    batches = int(stats["batches"])
    files = sorted(out2.glob("Prediction_*.json"))
    crowns = 0
    for f in files:
        for crown in json.loads(f.read_text()):
            ring = np.asarray(crown["polygon_coords"][0], dtype=np.float64)
            if ring.ndim != 2 or ring.shape[1] != 2 or \
                    not np.isfinite(ring).all() or \
                    not 0.0 < crown["score"] <= 1.0:
                fail(f"predictor: malformed crown in {f.name}")
            crowns += 1
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
    if launches != 2 * batches:
        fail(f"predictor: K1 launched {launches} times for {batches} batches")
    state["predictor"] = row
    state["tif"], state["meta"], state["pred"] = tif, meta, pred


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
    row = {"phase": "model", "dtype": "float32", "tf32": False,
           "pool_checks": errs, "kept_k1": int(out_k.valid.sum()),
           "kept_plain": int(out_p.valid.sum()), "same_kept_set": same_valid,
           "max_box_err_px": box_err, "max_score_err": score_err,
           "max_mask_err_u8": mask_err}
    emit(row)
    if not same_valid or box_err > 1e-2 or score_err > 1e-4 or mask_err > 2:
        fail("model: K1 and the plain pooler disagree inside the forward")
    if int(out_k.valid.sum()) == 0:
        fail("model: no detections in the compared batch")
    state["model"] = row


# --- phase 5: process_files end to end ---------------------------------------

SHEET_ORIGIN = (412000.0, 5318000.0)          # top-left corner, UTM32N-ish
SHEET_PX = 5000                               # 1 km at 0.2 m: 400 tiles of 50 m
NEIGHBOUR_PX = 1000                           # the adjacent 200 m sheet
DISCS_PER_KM2 = 7000


def write_synthetic_sheet(rgb_path: Path, ndsm_path: Path, side_px: int,
                          origin, n_discs: int, seed: int) -> None:
    """A square RGBI sheet at 0.2 m with crown-like discs (2-8 m radius:
    darker red/blue, raised NIR so that the NDVI gates pass them) on a
    lighter ground, and its 1 m nDSM with the same discs standing 5-25 m
    high.  Discs are drawn in local windows."""
    from treedetection_tpu_torch.geo import Affine, write_geotiff
    rng = np.random.default_rng(seed)
    h = w = side_px
    img = rng.standard_normal((h, w, 4), dtype=np.float32)
    img *= np.array([12, 12, 12, 10], dtype=np.float32)
    img += np.array([150, 160, 120, 110], dtype=np.float32)
    hm = side_px // 5
    ndsm = np.zeros((hm, hm), dtype=np.float32)
    for _ in range(n_discs):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        rad_m = rng.uniform(2.0, 8.0)
        rad = rad_m / 0.2
        y0, y1 = max(int(cy - rad), 0), min(int(cy + rad) + 1, h)
        x0, x1 = max(int(cx - rad), 0), min(int(cx + rad) + 1, w)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        d2 = ((yy - cy) ** 2 + (xx - cx) ** 2) / rad ** 2
        inside = d2 < 1.0
        shade = (0.55 + 0.3 * d2[inside]).astype(np.float32)
        win = img[y0:y1, x0:x1]
        win[inside, 0] *= shade * 0.6
        win[inside, 1] *= shade * 0.85
        win[inside, 2] *= shade * 0.6
        win[inside, 3] = np.minimum(win[inside, 3] * 1.8, 255)
        # the same disc on the 1 m grid, as a dome of 5-25 m
        top = rng.uniform(5.0, 25.0)
        my0, my1 = max(int(cy / 5 - rad_m), 0), min(int(cy / 5 + rad_m) + 1, hm)
        mx0, mx1 = max(int(cx / 5 - rad_m), 0), min(int(cx / 5 + rad_m) + 1, hm)
        myy, mxx = np.mgrid[my0:my1, mx0:mx1]
        md2 = ((myy + 0.5 - cy / 5) ** 2 + (mxx + 0.5 - cx / 5) ** 2) / rad_m ** 2
        dome = np.where(md2 < 1.0, top * (1.0 - 0.5 * md2), 0.0)
        ndsm[my0:my1, mx0:mx1] = np.maximum(ndsm[my0:my1, mx0:mx1], dome)
    rgb_path.parent.mkdir(parents=True, exist_ok=True)
    ndsm_path.parent.mkdir(parents=True, exist_ok=True)
    write_geotiff(str(rgb_path), np.clip(img, 0, 255).astype(np.uint8),
                  Affine.from_origin(origin[0], origin[1], 0.2, 0.2),
                  crs=25832, compress="none")
    write_geotiff(str(ndsm_path), ndsm,
                  Affine.from_origin(origin[0], origin[1], 1.0, 1.0),
                  crs=25832, nodata=-9999.0)


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


def phase_pipeline(state, workdir: Path):
    import torch
    from treedetection_tpu_torch import detection, postprocessing
    from treedetection_tpu_torch.config import Config, prepare_config
    from treedetection_tpu_torch.ops.kernels import pairwise as k234
    from treedetection_tpu_torch.ops.kernels import roi_align as k1
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

    os.environ["TD_PAIRS_DEVICE"] = "1"
    Config.reset()
    config, _ = prepare_config(pipeline_config(root), str(root))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    postprocessing.LAST_POSTPROCESS_STATS.clear()
    postprocessing.PAIR_KERNEL_CALLS.clear()
    k1.launches = 0                           # just before the main path
    for mode in k234.launches:
        k234.launches[mode] = 0
    t0 = time.time()
    outputs = detection.process_files(config)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"k1": k1.launches, **k234.launches}       # just after
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
    written = {}
    for p in outputs:
        rows, props, srs = _crown_multiset(p)
        if srs != 25832:
            fail(f"pipeline: {p} has SRS {srs}")
        for prop in props:
            if set(prop) != set(PROCESSED_PROPERTIES):
                fail(f"pipeline: properties {sorted(prop)} in {p}")
        written[Path(p).name] = len(rows)
    expected = {"dedupe": 0, "containment": 0}
    for kind, n, blocks in pair_calls:
        if blocks != math.ceil(n / postprocessing.PAIRWISE_BLOCK):
            fail(f"pipeline: {kind} call on {n} crowns ran {blocks} blocks")
        expected[kind] += blocks
    pred = config.get("_predictor_cache", {}).get(str(NPZ))
    row = {"phase": "pipeline", "config": "R50-FPN, 1024^2, batch 10, 512 "
           "proposals, bf16, TD_PAIRS_DEVICE=1",
           "sheet_px": [SHEET_PX, NEIGHBOUR_PX], "seam_strips": strips,
           "tiles_planned": tiles_planned, "tiles_predicted": tiles_predicted,
           "batches": batches, "crowns_stitched": stitched,
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
    if launches["k1"] != 2 * batches:
        fail(f"pipeline: K1 launched {launches['k1']} times for {batches} "
             f"batches")
    if launches["dedupe"] != expected["dedupe"] or launches["dedupe"] == 0 \
            or launches["containment"] != expected["containment"] \
            or launches["containment"] == 0:
        fail(f"pipeline: K2/K3 launches {launches} but the crown counts "
             f"{pair_calls} need {expected}")
    state["pipeline"] = row

    # (1) the host-grid branch on the same stitched layers
    del os.environ["TD_PAIRS_DEVICE"]
    before = dict(k234.launches)
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
    if k234.launches != before:
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

    # (2) a second call on the finished output predicts nothing
    os.environ["TD_PAIRS_DEVICE"] = "1"
    Config.reset()
    config2, _ = prepare_config(pipeline_config(root), str(root))
    k1.launches = 0
    t0 = time.time()
    outputs2 = detection.process_files(config2)
    resume_s = time.time() - t0
    del os.environ["TD_PAIRS_DEVICE"]
    emit({"phase": "pipeline_resume", "seconds": resume_s,
          "k1_launches": k1.launches,
          "predictor_built": "_predictor_cache" in config2,
          "outputs": [Path(p).name for p in outputs2]})
    if k1.launches or "_predictor_cache" in config2:
        fail("pipeline: the resumed run predicted again")
    if sorted(outputs2) != sorted(outputs):
        fail("pipeline: the resumed run returned other outputs")
    for handler in list(config2["logger"].handlers):
        config2["logger"].removeHandler(handler)
        handler.close()


# --- phase 6: summary ----------------------------------------------------------

def kernels_line(state):
    k = state["k1"]
    box, mask = k[("box", "bfloat16")], k[("mask", "bfloat16")]
    both = [box, mask]
    t_bytes = sum(r["bytes"] for r in both) / H100_BYTES_PER_S * 1e3
    t_ops = sum(r["flops"] for r in both) / PEAK_FLOPS["bfloat16"] * 1e3
    pipe = state["pipeline"]
    kernels = [{
        "name": "roi_pool_patches_flat",
        "route": "cuda",
        "source": "treedetection_tpu_torch/csrc/roi_pool_flat.cu",
        "replaces": "treedetection_tpu/ops/pallas/roi_align_kernel.py:172",
        "launches": pipe["launches"]["k1"],
        "launches_by_path": {"pipeline": pipe["launches"]["k1"],
                             "predictor": state["predictor"]["k1_launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in k.values()),
        "ms": box["ms"] + mask["ms"],
        "plain_ms": box["plain_ms"] + mask["plain_ms"],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "library_note": "no single PyTorch call computes this function",
        "per_batch_of": "box pool (N=5120, R=7) + mask pool (N=1000, R=14), "
                        "bf16, C=256, 1024^2 input, batch 10",
        "by_call": {f"{p}/{d}": {key: r[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
            for (p, d), r in k.items()},
    }]
    for mode, (number, wrapper, line) in PAIR_KERNELS.items():
        r = state["pairwise"][mode]
        kernels.append({
            "name": wrapper,
            "number": number,
            "route": "cuda",
            "source": "treedetection_tpu_torch/csrc/pairwise_boxes.cu",
            "replaces": f"treedetection_tpu/ops/pallas/iou_kernel.py:{line}",
            "launches": pipe["launches"][mode],
            "on_pipeline_path": mode != "iou",
            "max_abs_err": 0.0 if r["mismatches"] == 0 else 1.0,
            "mismatches": r["mismatches"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None,
            "library_note": "no single PyTorch call computes this function",
            "per_call_of": f"one row block, {r['shape'][0]} rows x "
                           f"{r['shape'][1]} columns, float32 in, uint8 out",
            **({} if mode != "iou" else {"note": (
                "no caller in either package: launched only by the kernel "
                "phase, where it is held against its plain version")}),
        })
    return {"kernels": kernels}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--profile", type=Path, default=None, metavar="DIR",
                    help="after the predictor phase, profile one more pass "
                         "and write its kernel table and trace to DIR")
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not (REPO / "treedetection_tpu_torch" / "__init__.py").is_file():
        fail("the treedetection_tpu_torch package is not beside this script")
    sys.path.insert(0, str(REPO))
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = {}
    t_start = time.time()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        if "build" in phases:
            phase_build()
        if "kernel" in phases:
            phase_kernel(state)
            phase_kernel_pairwise(state)
        if "predictor" in phases:
            phase_predictor(state, work)
            if args.profile is not None:
                phase_profile(state, work, args.profile)
        if "model" in phases:
            phase_model(state, work)
        if "pipeline" in phases:
            phase_pipeline(state, work)
    if set(phases) == set(PHASES):
        emit(kernels_line(state))
    emit({"phase": "done", "seconds": round(time.time() - t_start, 3)})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
