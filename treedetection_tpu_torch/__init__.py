"""treedetection_tpu_torch — the tree-crown detection system on PyTorch and
CUDA (NVIDIA Hopper).

A port of ``treedetection_tpu`` that imports nothing from it: each module
here mirrors its counterpart's name (``geo/``, ``native/``, ``ops/``,
``models/``, ``preprocessing.py``, ``config.py``, ``prediction.py``) and
keeps its own copy of what it needs.  Entry points run on the CUDA device
unless the caller's config asks for ``device: cpu``.

The one hand-written kernel of this slice, the flat ROIAlign patch pooler,
lives in ``ops/kernels/roi_align.py`` (CUDA C++ source under ``csrc/``).
"""

__version__ = "0.1.0"
