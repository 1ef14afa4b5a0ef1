"""Checkpoint loading: the JAX package's Flax param trees -> torch state dicts.

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

The detectron2 ``.pth`` reader comes in a later slice.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch


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


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Load a ``.npz`` checkpoint written by the JAX package
    (``save_checkpoint_npz``) as a ``MaskRCNN`` state dict."""
    if not path.endswith(".npz"):
        raise ValueError(f"unsupported checkpoint format: {path} (the port "
                         f"reads .npz; .pth comes in a later slice)")
    return from_flax_params(_load_npz_checkpoint(path, dtype=None))
