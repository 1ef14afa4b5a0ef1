"""The tile stream (``traffic/tile_stream.py``) through an MViTv2 Predictor.

The loop, the window, the traced segment, the stage marks after it, the
release and the close are ``tile_stream``'s.  Set-up and the comparison
differ in the model, as ``tile_stream_vitdet``'s do: the weights are drawn
from the seed by ``weights_mvit`` (calibrated with the float32 MViTv2
reference, ``reference/mvit.py``), and ``correct`` compares the judged
batches with that reference, by ``judge.py``'s numbers as the R101 cell
does.  Set-up raises where the Predictor did not load the seeded weights:
a program that cannot build the configuration's model fails there.
"""

from __future__ import annotations

import shutil
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

import judge as compare
import serving
import weights as weights_mod
import weights_mvit
from frozen.synthetic import make_sheet
from reference.maskrcnn import load_checkpoint
from reference.mvit import MViT
from traffic.tile_stream import (  # noqa: F401  (the traffic interface)
    _loop, after_trace, close, release, traced, window)


def make_weights_file(cell, seed: int, workdir: Path,
                      calibration_tiles: np.ndarray) -> Tuple[Path, float]:
    """``serving.make_weights_file`` for MViTv2: the seeded weights,
    calibrated on ``calibration_tiles`` with the reference (TF32 off), in
    one ``.npz`` -> its path and the calibration's seconds."""
    path = workdir / "weights.npz"
    init = dict(cell.config["weights"])
    init["calibration"] = dict(init["calibration"], **{
        k: v for k, v in cell.workload["traffic_params"].items()
        if k in init["calibration"]})
    dev = serving.device()
    w = weights_mvit.make_weights(cell.model, init, seed, dev)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        weights_mvit.calibrate(w, cell.model, init, calibration_tiles, dev)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    if dev.type == "cuda":
        torch.cuda.synchronize()
    calibration_s = time.perf_counter() - t0
    weights_mod.write_weights(str(path), w)
    return path, calibration_s


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
    weights_path, reference_s = make_weights_file(
        cell, int(rng.integers(0, 2 ** 31)), work, tiles[:4])
    parts("weights")

    from treedetection_tpu_torch.prediction import Predictor
    config = serving.program_config(cell, {
        "device": serving.device().type, "image_directory": str(work),
        "height_data_path": str(work), "output_directory": str(work / "out"),
        "tiles_path": str(work / "tiles")}, weights_path)
    pred = Predictor(config, str(weights_path))
    if pred.used_random_init:
        serving.close_config(config)
        shutil.rmtree(work, ignore_errors=True)
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


def reference(cell, weights_path: Path, quant=None) -> MViT:
    """The float32 MViTv2 reference (TF32 off), or with ``quant`` the
    control."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = load_checkpoint(str(weights_path), serving.device())
    return MViT(w, cell.model, quant=quant)


def judge(state):
    """The judged batches against the reference on the same tiles."""
    n_groups, bs = len(state["batches"]), state["bs"]
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
    ref = reference(cell, state["weights"])
    refs = serving.reference_tiles(ref, state["tiles"], judged)
    per_tile = [compare.tile_numbers(o, serving.tile_reference(r, k))
                for r, outs in zip(refs, judged) for k, o in enumerate(outs)]
    numbers = compare.summarize(per_tile)
    numbers["judged_tiles"] = float(len(per_tile))
    return numbers, dict(cell.workload["limits"])


def control(state, quant):
    """The control in the program's place: ``quant``'s reference over the
    cell's tiles, judged as the program is."""
    model = reference(state["cell"], state["weights"], quant=quant)
    outs = serving.control_outputs(model, state["tiles"])
    del model
    return judge_outputs(state, [[o] for o in outs])
