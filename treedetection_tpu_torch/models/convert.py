"""Checkpoint loading: Flax param trees and detectron2 state dicts -> the
port's torch state dict.

Numpy half of ``treedetection_tpu/models/convert.py`` (the ``.npz`` reader
and writer, the scanned <-> unrolled backbone restack, the fold of batch
statistics) plus :func:`from_flax_params`, which carries a Flax tree across
to :class:`~treedetection_tpu_torch.models.mask_rcnn.MaskRCNN`, and its
inverse :func:`to_flax_params`:

* conv kernels HWIO -> OIHW;
* ``res{s}_rest/block`` stacked leaves split into ``res{s}.{i}`` modules;
* norm ``scale``/``bias`` kept as they are; ``batch_stats`` ``mean``/``var``
  become the batch-norm modules' buffers of the same names;
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

Mask R-CNN ViTDet (``models/vit.py``; the JAX package has no such model) is
read from both: in the Flax layout its blocks are ``blocks_{i}`` (like the
unrolled ``res{s}_{i}``), layer norms ``scale``/``bias``, the pyramid's
deconvs ``deconv1``/``deconv2`` flipped as the mask head's ``deconv``; a
detectron2 state dict with ``backbone.net.*`` keys is mapped from
detectron2's own names (``backbone.simfp_{2..5}``, ``rpn_head.conv.conv{i}``,
the 4conv1fc box head, the heads' ``norm`` LayerNorms).  Mask R-CNN
MViTv2 (``models/mvit.py``) likewise: ``blocks_{i}`` of ``bottom_up`` in the
Flax layout (the depthwise pooling kernels (3, 3, 1, D)), and detectron2's
``backbone.bottom_up.*`` names, which the port's modules keep, with the
R-FPN heads.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from treedetection_tpu_torch.config import LOGGER_NAME
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
    if re.fullmatch(r"deconv\d*", path[-2]):
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
        m = re.match(r"(res\d+|blocks)_(\d+)$", p)
        parts.extend([m.group(1), m.group(2)] if m else [p])
    if parts[-1] == "kernel":
        parts[-1] = "weight"
    return ".".join(parts)


def from_flax_params(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax Mask R-CNN variables (``{"params": ...}`` with or without
    ``"batch_stats"``, or the bare params; scanned or unrolled backbone) ->
    ``MaskRCNN`` state dict (float32)."""
    sd: Dict[str, torch.Tensor] = {}

    def rec(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(path + [k], v)
        else:
            sd[_torch_key(path)] = torch.from_numpy(_torch_leaf(path, node))

    rec([], restack_backbone(tree.get("params", tree), scan=False))
    if tree.get("batch_stats"):
        rec([], restack_backbone(tree["batch_stats"], scan=False))
    return sd


def _flax_leaf(key: str, t: torch.Tensor) -> np.ndarray:
    """One state-dict entry -> its Flax layout (float32): the inverse of
    :func:`_torch_leaf`."""
    a = t.detach().to(device="cpu", dtype=torch.float32).numpy()
    if not key.endswith(".weight"):
        return a
    if re.search(r"\.deconv\d*\.", key):  # (in, out, kh, kw) -> flipped HWIO
        return np.ascontiguousarray(np.transpose(a, (2, 3, 0, 1))[::-1, ::-1])
    if a.ndim == 4:             # conv OIHW -> HWIO
        return np.ascontiguousarray(np.transpose(a, (2, 3, 1, 0)))
    if a.ndim == 2:             # dense (out, in) -> (in, out)
        return np.ascontiguousarray(a.T)
    raise ValueError(f"unexpected weight rank {a.ndim} at {key}")


def to_flax_params(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """``MaskRCNN`` state dict -> Flax variables in the scanned backbone
    layout: ``{"params": ...}``, plus ``"batch_stats"`` when the model has
    batch norm.  The inverse of :func:`from_flax_params`; with
    :func:`fold_batch_stats` and :func:`save_checkpoint_npz` it writes a
    checkpoint that both packages' ``load_checkpoint`` read."""
    trees: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        parts = key.split(".")
        path = []
        for i, p in enumerate(parts[:-1]):
            if p.isdigit() and re.match(r"res\d+$|blocks$", parts[i - 1]):
                path[-1] = f"{path[-1]}_{p}"
            else:
                path.append(p)
        leaf = parts[-1]
        kind = "batch_stats" if leaf in ("mean", "var") else "params"
        node = trees[kind]
        for p in path:
            node = node.setdefault(p, {})
        node["kernel" if leaf == "weight" else leaf] = _flax_leaf(key, t)
    return {k: restack_backbone(v, scan=True) for k, v in trees.items() if v}


def fold_batch_stats(variables: Mapping[str, Any],
                     eps: float = BN_EPS) -> Dict[str, Any]:
    """Fold a batch-norm-trained checkpoint (``{"params", "batch_stats"}``)
    into the frozen serving layout: every norm with (scale, bias) params and
    (mean, var) statistics becomes ``fold_frozen_bn``'s (scale, bias).
    Returns ``{"params": ...}`` with the tree a frozen model has; without
    batch_stats the params come back unchanged."""
    params = variables.get("params", variables)
    stats = variables.get("batch_stats") or {}

    def rec(p, s):
        if isinstance(p, Mapping):
            out = {}
            for k, v in p.items():
                if k in (s or {}) and isinstance(s[k], Mapping) \
                        and set(s[k].keys()) == {"mean", "var"} \
                        and set(v.keys()) >= {"scale", "bias"}:
                    gamma = np.asarray(v["scale"], np.float32)
                    beta = np.asarray(v["bias"], np.float32)
                    mean = np.asarray(s[k]["mean"], np.float32)
                    var = np.asarray(s[k]["var"], np.float32)
                    scale, bias = fold_frozen_bn(gamma, beta, mean, var, eps)
                    out[k] = {"scale": scale, "bias": bias}
                else:
                    out[k] = rec(v, (s or {}).get(k))
            return out
        return np.asarray(p)

    return {"params": rec(params, stats)}


def save_checkpoint_npz(path: str, params: Dict[str, Any],
                        dtype=np.float16) -> None:
    """Write a param tree to one compressed ``.npz`` (keys are ``/``-joined
    paths), atomically.  Leaves are stored in ``dtype`` (fp16 halves the
    file) unless that corrupts them: a leaf that overflows to inf, a small
    tensor (< 10 000 entries: norm affines) with any nonzero value flushed to
    0, or a large one with more than 1% of its nonzero values flushed stays
    float32; a large tensor with fewer flushed values is stored in fp16 with
    a warning."""
    flat: Dict[str, np.ndarray] = {}

    def rec(prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                rec(f"{prefix}/{k}" if prefix else k, v)
            return
        src = np.asarray(tree)
        with np.errstate(over="ignore"):
            cast = src.astype(dtype)
        if dtype == np.float16 and src.size:
            finite = np.isfinite(src)
            flushed = (src != 0) & finite & (cast == 0)
            n_flushed = int(flushed.sum())
            nonzero = max(int(((src != 0) & finite).sum()), 1)
            small = src.size < 10_000
            if (not np.isfinite(cast[finite]).all()
                    or (n_flushed > 0 if small
                        else n_flushed / nonzero > 0.01)):
                cast = src.astype(np.float32)
            elif n_flushed:
                logging.getLogger(LOGGER_NAME).warning(
                    f"fp16 checkpoint save flushed {n_flushed} tiny "
                    f"value(s) to zero in {prefix!r} ({src.size} entries)")
        flat[prefix] = cast

    rec("", params)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **flat)
    os.replace(tmp, path)


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
    """Map a detectron2 Mask R-CNN state dict to the ``MaskRCNN`` state dict
    (float32): R-FPN of ``depth``, ViTDet where it has ``backbone.net.*``
    keys (its depth and heads read from the keys), or MViTv2 where it has
    ``backbone.bottom_up.patch_embed.*`` keys (its depth read from them)."""
    if "backbone.net.patch_embed.proj.weight" in sd:
        return _convert_vitdet(sd, fpn_channels, box_pool)
    out: Dict[str, np.ndarray] = {}

    def convbn(dst: str, src: str) -> None:
        out[f"{dst}.conv.weight"] = _to_numpy(sd[f"{src}.weight"])
        scale, bias = fold_frozen_bn(
            *(_to_numpy(sd[f"{src}.norm.{k}"])
              for k in ("weight", "bias", "running_mean", "running_var")))
        out[f"{dst}.norm.scale"] = scale
        out[f"{dst}.norm.bias"] = bias

    if "backbone.bottom_up.patch_embed.proj.weight" in sd:
        _mvit_bottom_up(sd, out)
    else:
        convbn("backbone.bottom_up.stem", "backbone.bottom_up.stem.conv1")
        for stage, n_blocks in enumerate(STAGE_BLOCKS[depth]):
            for i in range(n_blocks):
                block = f"backbone.bottom_up.res{stage + 2}.{i}"
                for conv in ("conv1", "conv2", "conv3"):
                    convbn(f"{block}.{conv}", f"{block}.{conv}")
                if f"{block}.shortcut.weight" in sd:
                    convbn(f"{block}.shortcut", f"{block}.shortcut")
    _rfpn(sd, out, fpn_channels, box_pool)
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in out.items()}


def _rfpn(sd: Mapping[str, Any], out: Dict[str, np.ndarray],
          fpn_channels: int, box_pool: int) -> None:
    """detectron2's FPN (``backbone.fpn_{lateral,output}{2..5}``) and the
    R-FPN heads of ``mask_rcnn_fpn``, into ``out``."""
    def plain(dst: str, src: str) -> None:
        out[f"{dst}.weight"] = _to_numpy(sd[f"{src}.weight"])
        out[f"{dst}.bias"] = _to_numpy(sd[f"{src}.bias"])

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


def _mvit_bottom_up(sd: Mapping[str, Any], out: Dict[str, np.ndarray]
                    ) -> None:
    """detectron2's MViT (``backbone.bottom_up``: ``patch_embed.proj``,
    ``blocks.N.{norm1, attn.qkv, attn.pool_{q,k,v}, attn.norm_{q,k,v},
    attn.rel_pos_{h,w}, attn.proj, proj, norm2, mlp.fc1, mlp.fc2}``,
    ``scale{2..5}_norm``), into ``out`` under the same names, each
    LayerNorm's ``weight`` as ``scale``."""
    bu = "backbone.bottom_up"
    for key, value in sd.items():
        if not key.startswith(f"{bu}."):
            continue
        parts = key.split(".")
        if parts[-1] == "weight" and re.fullmatch(
                r"norm\d|norm_[qkv]|scale\d_norm", parts[-2]):
            parts[-1] = "scale"
        out[".".join(parts)] = _to_numpy(value)


def _convert_vitdet(sd: Mapping[str, Any], fpn_channels: int,
                    box_pool: int) -> Dict[str, torch.Tensor]:
    """detectron2's Mask R-CNN ViTDet (``projects/ViTDet``: ViT backbone,
    ``SimpleFeaturePyramid``, StandardRPNHead with several convs, the
    4conv1fc box head and the mask head with LN) -> ``MaskRCNN`` with
    ``backbone="vit"``."""
    out: Dict[str, np.ndarray] = {}

    def copy(dst: str, src: str, leaves=("weight", "bias")) -> None:
        for leaf in leaves:
            out[f"{dst}.{leaf}"] = _to_numpy(sd[f"{src}.{leaf}"])

    def norm(dst: str, src: str) -> None:     # LayerNorm weight -> scale
        out[f"{dst}.scale"] = _to_numpy(sd[f"{src}.weight"])
        out[f"{dst}.bias"] = _to_numpy(sd[f"{src}.bias"])

    def conv_ln(dst: str, src: str) -> None:  # conv without bias + its LN
        out[f"{dst}.weight"] = _to_numpy(sd[f"{src}.weight"])
        norm(f"{dst}.norm", f"{src}.norm")

    net = "backbone.net"
    copy(f"{net}.patch_embed.proj", f"{net}.patch_embed.proj")
    out[f"{net}.pos_embed"] = _to_numpy(sd[f"{net}.pos_embed"])
    n_blocks = len({k.split(".")[3] for k in sd
                    if k.startswith(f"{net}.blocks.")})
    for i in range(n_blocks):
        blk = f"{net}.blocks.{i}"
        norm(f"{blk}.norm1", f"{blk}.norm1")
        norm(f"{blk}.norm2", f"{blk}.norm2")
        for layer in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
            copy(f"{blk}.{layer}", f"{blk}.{layer}")
        copy(f"{blk}.attn", f"{blk}.attn", ("rel_pos_h", "rel_pos_w"))
    pyr = "backbone.pyramid"
    # detectron2's Sequential indices per level: (deconvs..., conv 1x1,
    # conv 3x3); simfp_2 holds deconv, LN, GELU, deconv first, simfp_5 its
    # max-pool
    copy(f"{pyr}.up2.deconv1", "backbone.simfp_2.0")
    norm(f"{pyr}.up2.norm", "backbone.simfp_2.1")
    copy(f"{pyr}.up2.deconv2", "backbone.simfp_2.3")
    copy(f"{pyr}.up3.deconv1", "backbone.simfp_3.0")
    for level, first in ((2, 4), (3, 1), (4, 0), (5, 1)):
        conv_ln(f"{pyr}.lateral{level}", f"backbone.simfp_{level}.{first}")
        conv_ln(f"{pyr}.output{level}",
                f"backbone.simfp_{level}.{first + 1}")
    rpn = "proposal_generator.rpn_head"
    n_rpn = len({k.split(".")[3] for k in sd
                 if k.startswith(f"{rpn}.conv.conv")})
    for i in range(n_rpn):
        copy(f"rpn_head.conv.conv{i}", f"{rpn}.conv.conv{i}")
    for name in ("objectness_logits", "anchor_deltas"):
        copy(f"rpn_head.{name}", f"{rpn}.{name}")
    box = "roi_heads.box_head"
    n_convs = len({k.split(".")[2] for k in sd
                   if re.match(rf"{box}\.conv\d+\.", k)})
    for i in range(1, n_convs + 1):
        conv_ln(f"box_head.conv{i}", f"{box}.conv{i}")
    copy("box_head.fc1", f"{box}.fc1")
    out["box_head.fc1.weight"] = fc1_weight_chw_to_hwc(
        out["box_head.fc1.weight"], fpn_channels, box_pool)
    copy("box_head.cls_score", "roi_heads.box_predictor.cls_score")
    copy("box_head.bbox_pred", "roi_heads.box_predictor.bbox_pred")
    for i in range(1, 5):
        conv_ln(f"mask_head.mask_fcn{i}", f"roi_heads.mask_head.mask_fcn{i}")
    for name in ("deconv", "predictor"):
        copy(f"mask_head.{name}", f"roi_heads.mask_head.{name}")
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in out.items()}


def load_checkpoint(path: str, depth: int = 101) -> Dict[str, torch.Tensor]:
    """Load a model checkpoint as a ``MaskRCNN`` state dict: a ``.npz``
    written by the JAX package (``save_checkpoint_npz``) or a detectron2
    ``.pth``/``.pkl`` (``depth`` names its ResNet; a ViTDet checkpoint is
    recognised by its keys)."""
    if path.endswith(".pth") or path.endswith(".pkl"):
        blob = torch.load(path, map_location="cpu", weights_only=False)
        sd = blob.get("model", blob) if isinstance(blob, dict) else blob
        return convert_detectron2_state_dict(sd, depth=depth)
    if path.endswith(".npz"):
        return from_flax_params(_load_npz_checkpoint(path, dtype=None))
    raise ValueError(f"unsupported checkpoint format: {path} (the port reads "
                     f".npz and detectron2 .pth/.pkl)")
