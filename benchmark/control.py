"""Readings of the numbers that decide ``correct``: the program's over many
seeds (the lower readings) and the control's (the upper readings).

    python3 benchmark/control.py --workload NAME --seeds 1,2,3 \\
        --control-seeds 1,2,3 --seconds S [--out FILE]

For each seed of ``--seeds``: the cell's set-up and a window of ``--seconds``
as ``run.py`` makes them, then the comparison with the reference.  For each
seed of ``--control-seeds``: the same set-up, then the control in the
program's place: the reference computed with every conv and dense layer's
input and weight rounded to float8 e4m3 (one scale per tensor), the nearest
precision below the configuration's bfloat16, judged as the program is.
Prints one JSON line per reading (and appends it to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]
os.environ["TRITON_CACHE_DIR"] = str(BENCH / "_cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BENCH / "_cache" / "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    import harness
    from reference.maskrcnn import fp8_e4m3
    cell = harness.Cell(args.workload)
    driver = cell.driver()

    def emit(rec):
        text = json.dumps(rec)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(text + "\n")

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    for seed in seeds(args.seeds):
        t0 = time.perf_counter()
        state = driver.setup(cell, seed)
        driver.window(state, args.seconds)
        driver.release(state)
        torch.cuda.empty_cache()
        numbers, limits = driver.judge(state)
        driver.close(state)
        emit({"workload": cell.name, "side": "program", "seed": seed,
              "numbers": numbers, "limits": limits,
              "seconds": time.perf_counter() - t0})
    for seed in seeds(args.control_seeds):
        t0 = time.perf_counter()
        state = driver.setup(cell, seed)
        driver.release(state)
        torch.cuda.empty_cache()
        numbers, limits = driver.control(state, fp8_e4m3)
        driver.close(state)
        emit({"workload": cell.name, "side": "control", "seed": seed,
              "numbers": numbers, "limits": limits,
              "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
