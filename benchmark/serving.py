"""What both drivers share: the weights from the seed, the program's
configuration, and the reference (or the control) over a set of tiles."""

from __future__ import annotations

import logging
import sys
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

import judge
import weights as weights_mod
from reference import maskrcnn as ref_model

REF_BATCH = 4


class Stopwatch:
    """Seconds of each part of a set-up, logged on standard error."""

    def __init__(self):
        self.t = time.perf_counter()
        self.parts: List[Tuple[str, float]] = []

    def __call__(self, name: str) -> None:
        if device().type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.parts.append((name, now - self.t))
        self.t = now

    def log(self, reference_s: float) -> None:
        text = ", ".join(f"{n} {s:.3f}" for n, s in self.parts)
        print(f"benchmark: set-up parts (s): {text}; the reference's "
              f"{reference_s:.3f} within weights", file=sys.stderr,
              flush=True)


def device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def make_weights_file(cell, seed: int, workdir: Path,
                      calibration_tiles: np.ndarray) -> Tuple[Path, float]:
    """The configuration's weights drawn from ``seed`` on the device and
    calibrated on ``calibration_tiles`` (``weights.calibrate``), in one
    ``.npz`` that the program and the reference both read -> its path and
    the seconds that the calibration's reference forwards took (they are
    the reference's, not the program's set-up).  A cell's traffic
    parameter named as a key of the configuration's ``calibration``
    replaces it: how many crowns a tile holds, and how their masks look,
    are the traffic's."""
    path = workdir / "weights.npz"
    init = dict(cell.config["weights"])
    init["calibration"] = dict(init["calibration"], **{
        k: v for k, v in cell.workload["traffic_params"].items()
        if k in init["calibration"]})
    w = weights_mod.make_weights(cell.model, init, seed, device())
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device().type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        weights_mod.calibrate(w, cell.model, init, calibration_tiles,
                              device())
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    if device().type == "cuda":
        torch.cuda.synchronize()
    calibration_s = time.perf_counter() - t0
    weights_mod.write_weights(str(path), w)
    return path, calibration_s


def program_config(cell, base: Dict, weights_path: Path) -> Dict:
    """The program's configuration dict: the configuration file's
    ``program`` keys, then ``base`` (the cell's paths and traffic keys)."""
    from treedetection_tpu_torch.config import Config, prepare_config
    raw = dict(cell.config["program"])
    raw.update(base)
    raw["combined_model"] = str(weights_path)
    Config.reset()
    config, _ = prepare_config(raw, str(weights_path.parent))
    logger = config["logger"]
    for handler in list(logger.handlers):   # stdout carries the result only
        if type(handler) is logging.StreamHandler:
            handler.setStream(sys.stderr)
    return config


def close_config(config: Dict) -> None:
    logger = config.get("logger")
    if logger is not None:
        for handler in list(logger.handlers):
            logger.removeHandler(handler)
            handler.close()


def tile_outputs(out) -> List[judge.TileOutput]:
    """A host ``ModelOutput`` of a batch -> one ``TileOutput`` per tile."""
    return [judge.TileOutput(
        boxes=np.asarray(out.boxes[i], np.float64),
        scores=np.asarray(out.scores[i], np.float64),
        masks=np.asarray(out.masks[i], np.float32) / 255.0,
        valid=np.asarray(out.valid[i], bool))
        for i in range(out.valid.shape[0])]


def reference(cell, weights_path: Path, quant=None) -> ref_model.MaskRCNN:
    """The float32 reference (TF32 off), or with ``quant`` the control."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = ref_model.load_checkpoint(str(weights_path), device())
    return ref_model.MaskRCNN(w, cell.model, quant=quant)


@torch.no_grad()
def reference_tiles(ref: ref_model.MaskRCNN, tiles: np.ndarray,
                    judged: Sequence[Sequence[judge.TileOutput]]
                    ) -> List[Dict]:
    """The reference over ``tiles`` (n, P, P, 3) uint8 -> per tile its
    detections before the budget's cut, the cut, its candidates, and its
    masks on the boxes of every output in ``judged[i]`` (the program's
    outputs of tile i, one per time it was served)."""
    out = []
    dev = device()
    for s in range(0, len(tiles), REF_BATCH):
        batch = torch.from_numpy(np.ascontiguousarray(
            tiles[s:s + REF_BATCH])).to(dev)
        feats, rpn = ref.features(batch)
        for j in range(batch.shape[0]):
            i = s + j
            dets = ref.detect(feats, rpn, j, cut=False)
            cand = ref.candidates(rpn, feats, j)
            masks = [ref.mask_head(
                feats[:4], j, torch.from_numpy(o.boxes[o.valid]).float()
                .to(dev)).cpu().numpy() for o in judged[i]]
            cut = int(ref.m["max_detections"])
            out.append({
                "boxes": dets.boxes.cpu().numpy(),
                "scores": dets.scores.cpu().numpy(),
                "cut": cut,
                "cand_boxes": cand.boxes.cpu().numpy(),
                "cand_scores": cand.scores.cpu().numpy(),
                "masks_on": masks,
            })
        del feats, rpn
    return out


def tile_reference(r: Dict, k: int) -> judge.TileReference:
    """The reference of one tile for its ``k``-th judged output."""
    cut = r["cut"]
    return judge.TileReference(
        det_boxes=r["boxes"][:cut], det_scores=r["scores"][:cut],
        cand_boxes=r["cand_boxes"], cand_scores=r["cand_scores"],
        masks_on_program=r["masks_on"][k])


@torch.no_grad()
def control_outputs(control: ref_model.MaskRCNN,
                    tiles: np.ndarray) -> List[judge.TileOutput]:
    """The control in the program's place: its detections over ``tiles``,
    cut to the budget, as the program reports them (masks in 1/255)."""
    out = []
    dev = device()
    d = int(control.m["max_detections"])
    for s in range(0, len(tiles), REF_BATCH):
        batch = torch.from_numpy(np.ascontiguousarray(
            tiles[s:s + REF_BATCH])).to(dev)
        feats, rpn = control.features(batch)
        for j in range(batch.shape[0]):
            det = control.detect(feats, rpn, j, cut=True)
            n = len(det.scores)
            boxes = np.zeros((d, 4))
            scores = np.zeros(d)
            masks = np.zeros((d,) + tuple(det.masks.shape[1:]), np.float32)
            valid = np.zeros(d, bool)
            boxes[:n] = det.boxes.cpu().numpy()
            scores[:n] = det.scores.cpu().numpy()
            masks[:n] = np.round(det.masks.cpu().numpy() * 255.0) / 255.0
            valid[:n] = True
            out.append(judge.TileOutput(boxes, scores, masks, valid))
    return out
