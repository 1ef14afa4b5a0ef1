"""treedetection_tpu_torch — the tree-crown detection system on PyTorch and
CUDA (NVIDIA Hopper).

A port of ``treedetection_tpu`` that imports nothing from it: each module
here mirrors its counterpart's name (``geo/``, ``native/``, ``ops/``,
``models/``, ``train/``, ``eval/``, ``autolabel/``, ``utils/``, the stage
modules) and keeps its own copy of what it needs.  Entry points run on the
CUDA device unless the caller asks for the CPU (``device: cpu`` in a
config, ``device="cpu"`` in a call).

The public surface is the JAX package's: ``Config``, ``get_config`` and
``setup_logging``, and the five stage functions of ``detection``
(``process_files``, ``preprocess_files``, ``predict_tiles``,
``postprocess_files``, ``cleanup_files``), resolved lazily.  The
hand-written CUDA kernels (the ROIAlign patch poolers and the pairwise box
relations) live in ``ops/kernels`` with their sources under ``csrc/``.
"""

__version__ = "0.1.0"

from treedetection_tpu_torch.config import Config, get_config, setup_logging  # noqa: F401

__all__ = [
    "Config",
    "get_config",
    "setup_logging",
]

_STAGES = ("process_files", "preprocess_files", "predict_tiles",
           "postprocess_files", "cleanup_files")


def __getattr__(name):
    # lazy, so that `import treedetection_tpu_torch` does not load the model
    # and stage modules
    if name in _STAGES:
        from treedetection_tpu_torch import detection
        return getattr(detection, name)
    raise AttributeError(
        f"module 'treedetection_tpu_torch' has no attribute {name!r}")
