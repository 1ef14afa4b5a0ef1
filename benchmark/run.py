"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell's files are found by name: its entry
in ``BENCHMARK.json``, ``benchmark/workloads/NAME.json``, its configuration's
file, the traffic driver ``benchmark/traffic/<traffic>.py`` and, with
``--trace 1``, one reader ``benchmark/metrics/<metric>.py`` per per-layer
metric.  A run: set-up (inputs and weights from the seed, the system built
and warmed on this cell's shapes), the measured window of ``--seconds``,
with ``--trace 1`` a traced segment after it, the peak memory read, the
program's state freed, then the comparison with the reference that decides
``correct``.  Standard output ends with the JSON line; the numbers compared,
each beside its limit, end standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# every build and kernel cache at a fixed place inside the checkout (the
# port's own kernels build into its package's _build/)
CACHE = BENCH / "_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(BENCH), str(ROOT)]


def log(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import harness
    import judge
    cell = harness.Cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    driver = cell.driver()

    state = driver.setup(cell, args.seed)
    torch.cuda.synchronize()
    # the reference's forwards that calibrate the seeded weights are not
    # the program's set-up
    elapsed = time.perf_counter() - T_START
    setup_s = elapsed - state.get("reference_s", 0.0)
    log(f"set-up {setup_s:.3f}s ({elapsed:.3f}s less "
        f"{state.get('reference_s', 0.0):.3f}s of the reference)")
    torch.cuda.reset_peak_memory_stats()

    win = driver.window(state, args.seconds)
    log(f"window {win['window_s']:.3f}s, attempted {win['attempted']}, "
        f"failed {win['failed']}")
    trace = None
    if args.trace:
        prof = harness.profiler()
        with prof:
            driver.traced(state)
        trace = harness.trace_summary(prof)
        log(f"traced segment {trace['window_s']:.3f}s, busy "
            f"{trace['busy_s']:.3f}s")
        win["trace"] = trace
        driver.after_trace(state, win)
    device = harness.device_info(cell.chips)
    driver.release(state)
    torch.cuda.empty_cache()

    numbers, limits = driver.judge(state)
    checks = [(k, numbers[k], limits[k]) for k in limits]
    correct = win["failed"] == 0 and judge.verdict(numbers, limits)

    driver.close(state)
    found = harness.forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        return 4

    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            value = harness.metric_reader(m["name"])(win)
            if value is not None:
                metrics[m["name"]] = (value, m["unit"])
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
        breakdown = {"device_ops": trace["device_ops"],
                     "idle_gaps": trace["idle_gaps"]}
    else:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else win[m["name"]]
            metrics[m["name"]] = (value, m["unit"])
        breakdown = None
    print(harness.line(correct, win["attempted"], win["failed"], metrics,
                       device, checks, breakdown), flush=True)
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr,
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
