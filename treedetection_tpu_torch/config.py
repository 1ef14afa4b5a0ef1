"""Configuration: YAML loading, defaults, the static model spec, and CUDA
device selection.

Counterpart of ``treedetection_tpu/config.py``: same YAML keys, same
defaults, same :class:`ModelSpec` fields where they mean something on a GPU.
Differences:

* ``device`` selects a torch device — ``cuda`` (default), ``cuda:N``, ``N``
  or ``cpu``.  A request for CUDA on a machine without it raises; it never
  becomes the CPU silently.
* The TPU-only knobs are not ported: the 512-input crash guard, ``fold_w``
  (W-folded res2 for the 128-lane MXU) and ``scan_blocks``.
  ``rpn_approx_topk_from`` is kept as a field so configs load unchanged, but
  the port always runs exact top-k.
* PyYAML is imported inside :func:`load_config` only; callers that pass a
  dict never need it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Tuple, Union

import torch

LOGGER_NAME = "treedetection_tpu_torch"


def load_config(config_path: str) -> Dict[str, Any]:
    """Load a raw YAML config file into a dict."""
    import yaml

    if not os.path.exists(config_path):
        raise FileNotFoundError(f"Config file not found: {config_path}")
    with open(config_path, "r") as fh:
        config = yaml.safe_load(fh) or {}
    if not isinstance(config, dict):
        raise ValueError(f"Config file {config_path} must contain a YAML mapping.")
    return config


def select_device(raw_device: Union[None, int, str, torch.device] = None
                  ) -> torch.device:
    """Normalize the ``device`` key to a ``torch.device``.

    ``None`` / ``"cuda"`` -> ``cuda:0``; ``"cuda:N"`` or ``N`` -> ``cuda:N``;
    ``"cpu"`` -> CPU.  Raises when CUDA is requested but unavailable, or the
    index is out of range.
    """
    if isinstance(raw_device, torch.device):
        dev = raw_device
    elif raw_device is None:
        dev = torch.device("cuda", 0)
    elif isinstance(raw_device, int) and not isinstance(raw_device, bool):
        dev = torch.device("cuda", raw_device)
    elif isinstance(raw_device, str):
        s = raw_device.strip().lower()
        if s == "cpu":
            dev = torch.device("cpu")
        elif s.isdigit():
            dev = torch.device("cuda", int(s))
        elif s == "cuda" or (s.startswith("cuda:") and s[5:].isdigit()):
            dev = torch.device("cuda", int(s[5:]) if ":" in s else 0)
        else:
            raise ValueError(f"Unrecognized device specification: {raw_device!r}")
    else:
        raise ValueError(f"Unrecognized device specification: {raw_device!r}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {raw_device!r} requested but CUDA is not available "
                f"(set `device: cpu` to run on the CPU)")
        idx = 0 if dev.index is None else dev.index
        if idx >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {raw_device!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible")
        dev = torch.device("cuda", idx)
    elif dev.type != "cpu":
        raise ValueError(f"Unsupported device type: {dev}")
    return dev


_DEFAULTS: Tuple[Tuple[str, Any], ...] = (
    # Paths / staging
    ("output_directory", "./output"),
    ("tiles_path", "./tiles"),
    # Tiling
    ("tile_width", 50),
    ("tile_height", 50),
    ("buffer", 20),
    ("batch_size", 10),
    # Overlap machinery
    ("use_overlap", True),
    ("overlapping_tiles_width", 3),
    ("overlapping_tiles_height", 3),
    ("merged_path", "merged"),
    ("image_merged_regex", "FDOP20_(\\d+)_(\\d+)_(\\d+)_(\\d+)_(\\d+)\\.tif"),
    ("height_data_merged_regex", "FDOP20_(\\d+)_(\\d+)\\.tif"),
    # Stitching
    ("iou_threshold", 0.5),
    ("confidence_threshold_stitching", 0.3),
    ("area_threshold", 1),
    # Postprocessing
    ("exclude_files", []),
    ("confidence_threshold", 0.3),
    ("containment_threshold", 0.9),
    ("height_threshold", 3),
    # Raster scaling factors
    ("ndvi_scaling_factor", 0.2),
    ("height_scaling_factor", 1.0),
    # Runtime
    ("parallel", True),
    ("num_workers", None),
    ("verbose", False),
    ("debug", False),
    ("keep_intermediate", False),
    ("timestamped_output_directory", False),
    ("simplify_tolerance", 0.2),
    ("building_shapes", None),
    # NDVI gates (example-config values)
    ("ndvi_mean_threshold", 0.1),
    ("ndvi_var_threshold", 0.1),
    # Model / runtime extras
    ("device", "cuda"),            # cuda | cuda:N | N | cpu
    ("model_input_size", 1024),    # static model input resolution (px)
    ("max_detections", 100),       # static per-tile detection budget
    ("mixed_precision", True),     # bfloat16 model on the GPU
    ("prefetch_batches", 2),       # Predictor pipeline depth: decode-prefetch
                                   # window AND batches kept in flight
    ("eager_stitch", True),        # read by the stitching slice; the port's
                                   # Predictor always writes JSON only
    ("stitch_cache_images", 8),
    ("pixel_mean", None),          # BGR mean override (default caffe values)
    ("pixel_std", None),           # BGR std override
)


def apply_defaults(config: Dict[str, Any]) -> Dict[str, Any]:
    """Fill every missing key of ``config`` from ``_DEFAULTS`` (in place)."""
    for key, default in _DEFAULTS:
        config.setdefault(key, default)
    return config


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static Mask R-CNN inference spec (counterpart of the JAX ``ModelSpec``).

    Budgets are static so every batch has the same shapes.
    """

    depth: int = 101                  # ResNet depth (50 or 101)
    num_classes: int = 1
    score_threshold: float = 0.3
    nms_threshold: float = 0.5
    input_size: int = 1024            # static square input (tiles resized)
    pre_nms_topk: int = 1000          # per FPN level
    post_nms_topk: int = 1000
    rpn_nms_threshold: float = 0.7
    max_detections: int = 100
    # Read so configs load unchanged; the port ALWAYS runs exact top-k (the
    # JAX package's approx_max_k is a TPU sort workaround).
    rpn_approx_topk_from: int = 16384
    mask_resolution: int = 28
    anchor_sizes: Tuple[int, ...] = (32, 64, 128, 256, 512)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    # detectron2 caffe-style preprocessing: BGR order, per-channel mean subtract
    pixel_mean: Tuple[float, ...] = (103.53, 116.28, 123.675)
    pixel_std: Tuple[float, ...] = (1.0, 1.0, 1.0)
    bf16: bool = True
    # Test-time resize: "fixed" scales the tile window to the full canvas;
    # "shortest_edge" reproduces detectron2 ResizeShortestEdge and zero-pads
    # the rest of the static canvas.
    test_resize: str = "fixed"
    resize_shortest_edge: int = 800
    resize_max_size: int = 1333


def model_spec(config: Dict[str, Any]) -> ModelSpec:
    """Build the static model spec from the user config."""
    overrides = {}
    if config.get("pixel_mean"):
        overrides["pixel_mean"] = tuple(float(v) for v in config["pixel_mean"])
    if config.get("pixel_std"):
        overrides["pixel_std"] = tuple(float(v) for v in config["pixel_std"])
    return ModelSpec(
        depth=int(config.get("model_depth", 101)),
        score_threshold=float(config.get("confidence_threshold_stitching", 0.3)),
        nms_threshold=0.5,
        input_size=int(config.get("model_input_size", 1024)),
        pre_nms_topk=int(config.get("rpn_pre_nms_topk", 1000)),
        post_nms_topk=int(config.get("rpn_post_nms_topk", 1000)),
        max_detections=int(config.get("max_detections", 100)),
        # kept for config compatibility only: the port runs exact top-k
        rpn_approx_topk_from=int(config.get("rpn_approx_topk_from", 16384)),
        bf16=bool(config.get("mixed_precision", True)),
        test_resize=str(config.get("test_resize", "fixed")),
        resize_shortest_edge=int(config.get("resize_shortest_edge", 800)),
        resize_max_size=int(config.get("resize_max_size", 1333)),
        **overrides,
    )
