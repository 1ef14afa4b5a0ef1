"""Checkpoint loading: Flax param trees and detectron2 state dicts -> the
port's torch state dict.

Numpy half of ``treedetection_tpu/models/convert.py`` (the ``.npz`` reader
and the scanned <-> unrolled backbone restack) plus :func:`from_flax_params`,
which carries a Flax tree across to :class:`~treedetection_tpu_torch.models.
mask_rcnn.MaskRCNN`:

* conv kernels HWIO -> OIHW;
* ``res{s}_rest/block`` stacked leaves split into ``res{s}.{i}`` modules;
* FrozenBN ``scale``/``bias`` kept as buffers;
* Dense ``(in, out)`` -> Linear ``(out, in)`` — ``fc1`` keeps the HWC input
  order the (N, R, R, C) pooled layout implies;
* the ConvTranspose kernel un-flipped back to torch's ``(in, out, kh, kw)``;
* every leaf widened to float32 (``model_full.npz`` stores float16).

:func:`convert_detectron2_state_dict` maps a detectron2 Mask R-CNN (R-FPN)
state dict straight to the same layout, with no Flax tree in between: conv
and deconv kernels stay as torch stores them, FrozenBatchNorm statistics are
folded into (scale, bias), and the ``fc1`` input columns are permuted from
torch's CHW flatten of the pooled feature to the HWC flatten of this model's
(N, R, R, C) pooled layout.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from treedetection_tpu_torch.models.resnet import STAGE_BLOCKS

BN_EPS = 1e-5  # detectron2 FrozenBatchNorm2d epsilon


def _stack_trees(trees):
    """Leaf-wise stack of same-structure dicts along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return np.stack([np.asarray(t) for t in trees])


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _load_npz_checkpoint(path: str, dtype=np.float32) -> Dict[str, Any]:
    """``/``-joined npz keys -> nested dict; ``dtype=None`` keeps each leaf's
    stored dtype."""
    out: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            arr = z[key]
            node[parts[-1]] = (arr[...] if dtype is None
                               else np.asarray(arr, dtype=dtype))
    return out


def restack_backbone(params: Dict[str, Any], scan: bool = True
                     ) -> Dict[str, Any]:
    """Convert the backbone block layout between the unrolled form
    (``res{s}_{i}`` for every block) and the scanned form (``res{s}_0`` +
    ``res{s}_rest/block`` with a leading stacked axis).  No-op when the tree
    already has the requested layout."""
    tree = params.get("params", params)
    bottom_up = tree.get("backbone", {}).get("bottom_up")
    if not isinstance(bottom_up, dict):
        return params
    names = list(bottom_up.keys())
    unrolled = sorted(
        (m for m in (re.match(r"res(\d+)_(\d+)$", n) for n in names) if m),
        key=lambda m: (int(m.group(1)), int(m.group(2))))
    has_rest = any(n.endswith("_rest") for n in names)
    new_bu = dict(bottom_up)
    if scan and not has_rest:
        stages: Dict[int, list] = {}
        for m in unrolled:
            stages.setdefault(int(m.group(1)), []).append(m)
        for s, ms in stages.items():
            if len(ms) < 2:
                continue
            rest = [new_bu.pop(m.group(0)) for m in ms[1:]]
            new_bu[f"res{s}_rest"] = {"block": _stack_trees(rest)}
    elif not scan and has_rest:
        for n in [n for n in names if n.endswith("_rest")]:
            s = int(re.match(r"res(\d+)_rest", n).group(1))
            stacked = new_bu.pop(n)["block"]
            length = len(_first_leaf(stacked))

            def take(t, i):
                if isinstance(t, dict):
                    return {k: take(v, i) for k, v in t.items()}
                return np.asarray(t)[i]

            for i in range(length):
                new_bu[f"res{s}_{i + 1}"] = take(stacked, i)
    else:
        return params
    tree = dict(tree)
    tree["backbone"] = dict(tree["backbone"])
    tree["backbone"]["bottom_up"] = new_bu
    return {"params": tree} if "params" in params else tree


def _torch_leaf(path: list, leaf: np.ndarray) -> np.ndarray:
    """One Flax leaf -> its torch layout (float32)."""
    a = np.asarray(leaf, dtype=np.float32)
    if path[-1] != "kernel":
        return a
    if path[-2] == "deconv":
        # flax (kh, kw, in, out) holds the spatially flipped torch kernel
        return np.ascontiguousarray(np.transpose(a[::-1, ::-1], (2, 3, 0, 1)))
    if a.ndim == 4:                                   # conv HWIO -> OIHW
        return np.ascontiguousarray(np.transpose(a, (3, 2, 0, 1)))
    if a.ndim == 2:                                   # dense (in, out) -> (out, in)
        return np.ascontiguousarray(a.T)
    raise ValueError(f"unexpected kernel rank {a.ndim} at {'/'.join(path)}")


def _torch_key(path: list) -> str:
    parts = []
    for p in path:
        m = re.match(r"(res\d+)_(\d+)$", p)
        parts.extend([m.group(1), m.group(2)] if m else [p])
    if parts[-1] == "kernel":
        parts[-1] = "weight"
    return ".".join(parts)


def from_flax_params(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax Mask R-CNN param tree (``{"params": ...}`` or the bare params,
    scanned or unrolled backbone) -> ``MaskRCNN`` state dict (float32)."""
    params = restack_backbone(tree.get("params", tree), scan=False)
    sd: Dict[str, torch.Tensor] = {}

    def rec(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(path + [k], v)
        else:
            sd[_torch_key(path)] = torch.from_numpy(_torch_leaf(path, node))

    rec([], params)
    return sd


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def fold_frozen_bn(gamma: np.ndarray, beta: np.ndarray, mean: np.ndarray,
                   var: np.ndarray, eps: float = BN_EPS
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(gamma, beta, running_mean, running_var) -> (scale, bias) such that
    ``x * scale + bias == (x - mean) / sqrt(var + eps) * gamma + beta``."""
    scale = gamma / np.sqrt(var + eps)
    return scale, beta - mean * scale


def fc1_weight_chw_to_hwc(w: np.ndarray, channels: int, resolution: int
                          ) -> np.ndarray:
    """Permute fc1 input columns from torch's CHW flatten of the (C, R, R)
    pooled feature to the HWC flatten of (R, R, C); stays (out, in)."""
    out_dim = w.shape[0]
    w4 = w.reshape(out_dim, channels, resolution, resolution)
    return np.transpose(w4, (0, 2, 3, 1)).reshape(out_dim, -1)


def convert_detectron2_state_dict(sd: Mapping[str, Any], depth: int = 101,
                                  fpn_channels: int = 256, box_pool: int = 7
                                  ) -> Dict[str, torch.Tensor]:
    """Map a detectron2 Mask R-CNN (R-FPN) state dict to the ``MaskRCNN``
    state dict (float32)."""
    out: Dict[str, np.ndarray] = {}

    def plain(dst: str, src: str) -> None:
        out[f"{dst}.weight"] = _to_numpy(sd[f"{src}.weight"])
        out[f"{dst}.bias"] = _to_numpy(sd[f"{src}.bias"])

    def convbn(dst: str, src: str) -> None:
        out[f"{dst}.conv.weight"] = _to_numpy(sd[f"{src}.weight"])
        scale, bias = fold_frozen_bn(
            *(_to_numpy(sd[f"{src}.norm.{k}"])
              for k in ("weight", "bias", "running_mean", "running_var")))
        out[f"{dst}.norm.scale"] = scale
        out[f"{dst}.norm.bias"] = bias

    convbn("backbone.bottom_up.stem", "backbone.bottom_up.stem.conv1")
    for stage, n_blocks in enumerate(STAGE_BLOCKS[depth]):
        for i in range(n_blocks):
            block = f"backbone.bottom_up.res{stage + 2}.{i}"
            for conv in ("conv1", "conv2", "conv3"):
                convbn(f"{block}.{conv}", f"{block}.{conv}")
            if f"{block}.shortcut.weight" in sd:
                convbn(f"{block}.shortcut", f"{block}.shortcut")
    for lvl in range(2, 6):
        plain(f"backbone.fpn.lateral{lvl}", f"backbone.fpn_lateral{lvl}")
        plain(f"backbone.fpn.output{lvl}", f"backbone.fpn_output{lvl}")
    for name in ("conv", "objectness_logits", "anchor_deltas"):
        plain(f"rpn_head.{name}", f"proposal_generator.rpn_head.{name}")
    plain("box_head.fc1", "roi_heads.box_head.fc1")
    out["box_head.fc1.weight"] = fc1_weight_chw_to_hwc(
        out["box_head.fc1.weight"], fpn_channels, box_pool)
    plain("box_head.fc2", "roi_heads.box_head.fc2")
    plain("box_head.cls_score", "roi_heads.box_predictor.cls_score")
    plain("box_head.bbox_pred", "roi_heads.box_predictor.bbox_pred")
    for name in ("mask_fcn1", "mask_fcn2", "mask_fcn3", "mask_fcn4", "deconv",
                 "predictor"):
        plain(f"mask_head.{name}", f"roi_heads.mask_head.{name}")
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in out.items()}


def load_checkpoint(path: str, depth: int = 101) -> Dict[str, torch.Tensor]:
    """Load a model checkpoint as a ``MaskRCNN`` state dict: a ``.npz``
    written by the JAX package (``save_checkpoint_npz``) or a detectron2
    ``.pth``/``.pkl`` (``depth`` names its ResNet)."""
    if path.endswith(".pth") or path.endswith(".pkl"):
        blob = torch.load(path, map_location="cpu", weights_only=False)
        sd = blob.get("model", blob) if isinstance(blob, dict) else blob
        return convert_detectron2_state_dict(sd, depth=depth)
    if path.endswith(".npz"):
        return from_flax_params(_load_npz_checkpoint(path, dtype=None))
    raise ValueError(f"unsupported checkpoint format: {path} (the port reads "
                     f".npz and detectron2 .pth/.pkl)")
