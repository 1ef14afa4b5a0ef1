"""Configuration: YAML loading, defaults, the static model spec, and CUDA
device selection.

Counterpart of ``treedetection_tpu/config.py``: same YAML keys, same
defaults, same :class:`ModelSpec` fields where they mean something on a GPU.
Differences:

* ``device`` selects a torch device — ``cuda`` (default), ``cuda:N``, ``N``
  or ``cpu``.  A request for CUDA on a machine without it raises; it never
  becomes the CPU silently.  ``devices`` (a list of such entries, resolved
  from ``device`` where it is not given: :func:`select_devices`) are the
  devices a Predictor splits its batches over, as the JAX package's
  ``devices`` are its mesh.
* The TPU-only knobs are not ported: the 512-input crash guard, ``fold_w``
  (W-folded res2 for the 128-lane MXU) and ``scan_blocks``.
  ``rpn_approx_topk_from`` is kept as a field so configs load unchanged, but
  the port always runs exact top-k.
* PyYAML is imported inside :func:`load_config` only; callers that pass a
  dict to :func:`prepare_config` never need it.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys
import time
from typing import Any, Dict, List, Tuple, Union

import torch

LOGGER_NAME = "treedetection_tpu_torch"


class Config:
    """Process-global attribute bag shared by every stage: config dict keys
    become class attributes.  Kept for API parity with the JAX package; new
    code should prefer passing the config dict explicitly."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def _load_into_config(self, config: Dict[str, Any]) -> None:
        for key, value in config.items():
            setattr(type(self), key, value)

    @classmethod
    def reset(cls) -> None:
        """Drop all loaded attributes (used by tests)."""
        for key in list(vars(cls)):
            if not key.startswith("_") and key != "reset":
                try:
                    delattr(cls, key)
                except AttributeError:
                    pass
        cls._instance = None


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


def setup_logging(log_dir: str, debug: bool = False) -> logging.Logger:
    """Timestamped file log + console handler."""
    os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(logging.DEBUG if debug else logging.INFO)
    # Reset handlers so repeated get_config calls don't stack duplicates.
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    timestamp = time.strftime("%Y%m%d-%H%M%S")
    file_handler = logging.FileHandler(os.path.join(log_dir, f"run_{timestamp}.log"))
    file_handler.setLevel(logging.DEBUG)
    console = logging.StreamHandler(sys.stdout)
    console.setLevel(logging.DEBUG if debug else logging.INFO)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    file_handler.setFormatter(fmt)
    console.setFormatter(fmt)
    logger.addHandler(file_handler)
    logger.addHandler(console)
    logger.propagate = False
    return logger


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


def select_devices(raw_device: Union[None, int, str, torch.device] = None
                   ) -> List[torch.device]:
    """The devices ``device`` selects for a Predictor to split its batches
    over.  ``None`` / ``"cuda"`` (no index) -> every visible card, as the
    JAX package's default device list is every device, except under a
    launcher that starts several processes per host (``LOCAL_WORLD_SIZE``
    > 1, as torchrun sets it), where each process takes its own card,
    ``cuda:LOCAL_RANK``; anything else -> the one device
    :func:`select_device` gives."""
    first = select_device(raw_device)
    plain = raw_device is None or (isinstance(raw_device, str)
                                   and raw_device.strip().lower() == "cuda")
    if first.type != "cuda" or not plain:
        return [first]
    if int(os.environ.get("LOCAL_WORLD_SIZE") or 1) > 1:
        return [select_device(int(os.environ.get("LOCAL_RANK") or 0))]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


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
    ("mesh_shape", None),          # e.g. {"data": 2}: the first 2 devices;
                                   # None -> every device of `devices`
    ("model_input_size", 1024),    # static model input resolution (px)
    ("max_detections", 100),       # static per-tile detection budget
    ("mixed_precision", True),     # bfloat16 model on the GPU
    ("prefetch_batches", 2),       # Predictor pipeline depth: decode-prefetch
                                   # window AND batches kept in flight
    ("eager_stitch", True),        # stitch transform at predict flush (the
                                   # stitch stage then skips JSON re-parse)
    ("stitch_cache_images", 8),    # eager-sink capacity before file fallback
    ("pixel_mean", None),          # BGR mean override (default caffe values)
    ("pixel_std", None),           # BGR std override
)


def apply_defaults(config: Dict[str, Any]) -> Dict[str, Any]:
    """Fill every missing key of ``config`` from ``_DEFAULTS`` (in place)."""
    for key, default in _DEFAULTS:
        config.setdefault(key, default)
    return config


def prepare_config(config: Dict[str, Any], base_dir: str
                   ) -> Tuple[Dict[str, Any], Config]:
    """Validate and default-fill a raw config dict (in place): resolve the
    path keys against ``base_dir``, check the inputs and the model files,
    fill ``_DEFAULTS``, create the output and tile directories, resolve
    ``devices`` (a list of ``torch.device``; CUDA requested without a card
    raises) and set ``device`` to the first,
    attach the logger, and load the :class:`Config` singleton.  Everything
    :func:`get_config` does after reading the YAML; callers that already
    hold a dict start here."""
    base = os.path.abspath(base_dir)

    def _resolve(p):
        if p is None:
            return None
        return p if os.path.isabs(p) else os.path.normpath(os.path.join(base, p))

    # NOTE: merged_path is deliberately NOT resolved — it is a bare
    # subdirectory NAME joined under each image directory (detection.py,
    # merging.py), not a path; resolving it to an absolute path would make
    # os.path.join discard the image directory and lose every seam strip.
    for key in ("image_directory", "height_data_path", "combined_model",
                "urban_model", "forrest_model", "forrest_outline",
                "output_directory", "tiles_path", "continue_path"):
        if config.get(key):
            config[key] = _resolve(config[key])
    if config.get("exclude_files"):
        config["exclude_files"] = [_resolve(p) for p in config["exclude_files"]]

    assert config.get("image_directory") and os.path.exists(config["image_directory"]), (
        "Config key 'image_directory' is unset or does not point to an existing path.")
    assert config.get("height_data_path") and os.path.exists(config["height_data_path"]), (
        "Config key 'height_data_path' (nDSM rasters) is unset or does not point to an existing path.")

    if not config.get("combined_model") or not os.path.exists(config["combined_model"]):
        assert config.get("urban_model") and os.path.exists(config["urban_model"]), (
            "No 'combined_model' given, and 'urban_model' is unset or not an existing file.")
        assert config.get("forrest_model") and os.path.exists(config["forrest_model"]), (
            "No 'combined_model' given, and 'forrest_model' is unset or not an existing file.")
        assert config.get("forrest_outline") and os.path.exists(config["forrest_outline"]), (
            "Two-model routing needs 'forrest_outline', which is unset or not an existing file.")

    config["continue"] = config.get(
        "continue_path", os.path.join(config.get("output_directory", "./output"), "continue.yml"))

    # the NDVI gates are defaulted, but that changes postprocess filters for
    # migrated reference configs — warn so the assumption is visible
    missing_ndvi = [k for k in ("ndvi_mean_threshold", "ndvi_var_threshold")
                    if k not in config]

    apply_defaults(config)

    os.makedirs(config["output_directory"], exist_ok=True)
    os.makedirs(config["tiles_path"], exist_ok=True)

    raw_devices = config.get("devices")
    config["devices"] = ([select_device(d) for d in raw_devices]
                         if raw_devices else
                         select_devices(config.get("device")))
    config["device"] = config["devices"][0]

    config["logger"] = setup_logging(
        os.path.join(config["output_directory"], "logs"), config["debug"])
    if missing_ndvi:
        config["logger"].warning(
            f"Config keys {missing_ndvi} not set; defaulting to the "
            f"example-config values (0.1). The reference requires these "
            f"explicitly — review the NDVI gates for your imagery.")

    config_obj = Config()
    config_obj._load_into_config(config)
    return config, config_obj


def get_config(config_path: str) -> Tuple[Dict[str, Any], Config]:
    """Load + validate + default-fill the YAML config: returns
    ``(config_dict, Config_singleton)``.  Relative paths resolve against the
    config file's directory."""
    return prepare_config(load_config(config_path),
                          os.path.dirname(os.path.abspath(config_path)))


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
