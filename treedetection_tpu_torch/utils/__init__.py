"""Utilities: stage timing, progress reporting and profiler traces
(counterpart of ``treedetection_tpu/utils``)."""

from treedetection_tpu_torch.utils.profiling import (  # noqa: F401
    StageTimer, profile_trace, log_progress)
