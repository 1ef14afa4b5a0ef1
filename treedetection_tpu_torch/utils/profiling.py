"""Profiling and timing helpers (counterpart of
``treedetection_tpu/utils/profiling.py``; the trace is ``torch.profiler``'s)."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional


class StageTimer:
    """Named wall-clock spans, logged at DEBUG like the reference's stage
    timing (reference ``detection.py:350-373``) and queryable afterwards."""

    def __init__(self, logger=None):
        self.logger = logger
        self.spans: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.spans[name] = self.spans.get(name, 0.0) + dt
            if self.logger:
                self.logger.debug(f"{name} took {dt:.2f}s")

    def summary(self) -> str:
        total = sum(self.spans.values()) or 1e-12  # no spans yet -> 0%
        lines = [f"  {k}: {v:.2f}s ({v / total * 100:.0f}%)"
                 for k, v in sorted(self.spans.items(), key=lambda kv: -kv[1])]
        return f"Stage timing (total {total:.2f}s):\n" + "\n".join(lines)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile a block with ``torch.profiler`` (CPU activity, and CUDA's
    where a card is visible) and write its Chrome trace to
    ``<log_dir>/trace_<pid>_<time>.json`` on exit; no-op when ``log_dir``
    is falsy."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def log_progress(logger, done: int, total: int, label: str,
                 every_pct: int = 5) -> None:
    """Throttled progress lines every N percent (reference
    ``detection.py:124-128``)."""
    if logger is None or total <= 0:
        return
    step = max(1, total * every_pct // 100)
    if done % step == 0 or done == total:
        logger.info(f"{label}: {done}/{total} ({done * 100 // total}%)")
