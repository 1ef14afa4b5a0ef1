"""A closed loop of tile batches through the program's ``Predictor``.

Set-up draws a sheet piece from the seed with the frozen generator and cuts
``tiles`` distinct windows of ``pad`` pixels from it at seeded places; they
are served in batches of the configuration's ``batch_size``, in turn.  The
``Predictor`` is built from the configuration, with the weights drawn from
the seed: its own model copy, its pinned copy and ``preprocess``, and its
per-batch forward (``_get_forward(pad)``) on its device thread
(``_dispatch``), as ``Predictor.warmup`` drives them.  ``in_flight`` batches
are outstanding at once; the main thread only waits on each batch's event.

A batch's latency runs from its submission to the device thread until its
outputs are on the host.  The window ends with the last batch that was
submitted before ``--seconds`` had passed.  ``correct`` compares a sample
of the window's batches, drawn from the seed, with the reference on the
same tiles.
"""

from __future__ import annotations

import shutil
import tempfile
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

import judge as compare
import serving
from frozen.synthetic import make_sheet


def setup(cell, seed: int) -> Dict[str, Any]:
    t = cell.workload["traffic_params"]
    work = Path(tempfile.mkdtemp(prefix=f"bench_{cell.name}_"))
    rng = np.random.default_rng(seed)
    parts = serving.Stopwatch()
    side = int(t["sheet_px"])
    rgbi, _ = make_sheet(side, int(round(
        t["discs_per_km2"] * (side * 0.2 / 1000.0) ** 2)),
        int(rng.integers(0, 2 ** 31)))
    pad = int(t["pad"])
    ys = rng.integers(0, side - pad, int(t["tiles"]))
    xs = rng.integers(0, side - pad, int(t["tiles"]))
    tiles = np.stack([rgbi[y:y + pad, x:x + pad, :3]
                      for y, x in zip(ys, xs)])
    parts("tiles")
    weights_path, reference_s = serving.make_weights_file(
        cell, int(rng.integers(0, 2 ** 31)), work, tiles[:4])
    parts("weights")

    from treedetection_tpu_torch.prediction import Predictor
    config = serving.program_config(cell, {
        "device": serving.device().type, "image_directory": str(work),
        "height_data_path": str(work), "output_directory": str(work / "out"),
        "tiles_path": str(work / "tiles")}, weights_path)
    pred = Predictor(config, str(weights_path))
    if pred.used_random_init:
        raise RuntimeError("the Predictor did not load the seeded weights")
    parts("predictor")
    bs = pred.batch_size
    batches = [np.ascontiguousarray(tiles[i:i + bs])
               for i in range(0, len(tiles), bs)]
    forward, _ = pred._get_forward(pad)
    pred.warmup(pad)
    parts("warmup")
    state = {"cell": cell, "t": t, "work": work, "tiles": tiles, "pad": pad,
             "weights": weights_path, "config": config, "pred": pred,
             "forward": forward, "batches": batches, "bs": bs,
             "rng": rng, "in_flight": int(t["in_flight"]),
             "reference_s": reference_s}
    _loop(state, len(batches), keep=False)           # one turn, warm
    parts("warm turn")
    parts.log(reference_s)
    return state


def _loop(state, n_batches=None, seconds=None, keep=True) -> Dict[str, Any]:
    """The closed loop: ``n_batches`` batches, or batches until
    ``seconds`` have passed -> latencies and the kept outputs."""
    pred, forward, batches = state["pred"], state["forward"], state["batches"]
    inflight: deque = deque()
    lat = []
    kept: Dict[int, Any] = {}
    submitted = done = 0
    t0 = time.perf_counter()

    def submit():
        nonlocal submitted
        inflight.append((submitted, time.perf_counter(), pred._dispatch.submit(
            forward, batches[submitted % len(batches)])))
        submitted += 1

    def more():
        if seconds is None:
            return submitted < n_batches
        return time.perf_counter() - t0 < seconds

    while len(inflight) < state["in_flight"] and more():
        submit()
    while inflight:
        k, t_sub, fut = inflight.popleft()
        parts = fut.result()
        for _, event in parts:
            if event is not None:
                event.synchronize()
        lat.append(time.perf_counter() - t_sub)
        done += 1
        if keep:
            kept[k] = parts[0][0]
        if more():
            submit()
    return {"t0": t0, "t1": time.perf_counter(), "lat": lat, "done": done,
            "submitted": submitted, "kept": kept}


def window(state, seconds: float) -> Dict[str, Any]:
    r = _loop(state, seconds=seconds)
    span = r["t1"] - r["t0"]
    n_keep = int(state["t"]["judged_batches"])
    idx = sorted(r["kept"])
    pick = set(state["rng"].choice(idx, size=min(n_keep, len(idx)),
                                   replace=False).tolist())
    pick.add(idx[-1])                       # the last one always
    state["judged"] = {k: r["kept"][k] for k in pick}
    lat_ms = np.asarray(r["lat"]) * 1e3
    tiles = r["done"] * state["bs"]
    return {
        "window_s": span, "attempted": r["submitted"],
        "failed": r["submitted"] - r["done"],
        "tiles_per_s": tiles / span,
        "batch_ms_p95": float(np.percentile(lat_ms, 95)),
        "batches": r["done"], "model": state["cell"].model,
        "batch_size": state["bs"],
    }


def traced(state) -> None:
    r = _loop(state, n_batches=int(state["t"]["traced_batches"]), keep=False)
    state["traced"] = {"batches": r["done"], "span_s": r["t1"] - r["t0"]}


def after_trace(state, records: Dict[str, Any]) -> None:
    """The forward's stage marks (CUDA events) on the Predictor's own model,
    over a few batches after the window, on its device thread."""
    pred, pad = state["pred"], state["pad"]
    runs = []

    def marked(raw: np.ndarray):
        x = pred.preprocess(torch.from_numpy(raw).to(pred.device), pad)
        start = torch.cuda.Event(enable_timing=True)
        marks = {}

        def mark(stage):
            marks[stage] = torch.cuda.Event(enable_timing=True)
            marks[stage].record()

        start.record()
        with torch.no_grad():
            pred.model(x, mark=mark)
        torch.cuda.synchronize()
        return start, marks

    for i in range(int(state["t"]["marked_batches"])):
        start, marks = pred._dispatch.submit(
            marked, state["batches"][i % len(state["batches"])]).result()
        runs.append((start.elapsed_time(marks["rpn"]),
                     marks["rpn"].elapsed_time(marks["maskhead"])))
    records["stage_ms"] = runs
    records["traced"] = state["traced"]


def release(state) -> None:
    for key in ("pred", "forward"):
        state.pop(key, None)
    serving.close_config(state.pop("config"))


def judge(state):
    """The judged batches against the reference on the same tiles."""
    n_groups, bs = len(state["batches"]), state["bs"]
    # judged[i]: every judged output of tile i (tile i is row i % bs of
    # batch group i // bs)
    judged = [[] for _ in range(len(state["tiles"]))]
    for k, out in sorted(state["judged"].items()):
        g = k % n_groups
        for j, o in enumerate(serving.tile_outputs(out)):
            judged[g * bs + j].append(o)
    return judge_outputs(state, judged)


def judge_outputs(state, judged):
    """``judged[i]``, the outputs of tile i to judge, against the
    reference -> (numbers, limits)."""
    cell = state["cell"]
    ref = serving.reference(cell, state["weights"])
    refs = serving.reference_tiles(ref, state["tiles"], judged)
    per_tile = [compare.tile_numbers(o, serving.tile_reference(r, k))
                for r, outs in zip(refs, judged) for k, o in enumerate(outs)]
    numbers = compare.summarize(per_tile)
    numbers["judged_tiles"] = float(len(per_tile))
    return numbers, dict(cell.workload["limits"])


def control(state, quant):
    """The control in the program's place: ``quant``'s reference over the
    cell's tiles, judged as the program is."""
    model = serving.reference(state["cell"], state["weights"], quant=quant)
    outs = serving.control_outputs(model, state["tiles"])
    del model
    return judge_outputs(state, [[o] for o in outs])


def close(state) -> None:
    shutil.rmtree(state["work"], ignore_errors=True)
