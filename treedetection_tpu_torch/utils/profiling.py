"""Profiling and timing helpers (counterpart of
``treedetection_tpu/utils/profiling.py``; the trace is ``torch.profiler``'s).

Besides the JAX package's ``StageTimer`` and ``profile_trace``, one span
facility for the serving path.  :class:`Span` is the stopwatch of every
span, ``StageTimer``'s included; while tracing is on, which is exactly
while a ``torch.profiler`` session runs anywhere in the process (the
benchmark's traced segment, the Predictor's ``profile_dir``), a span also
enters ``torch.profiler.record_function``, so it lands on the profiler's
clock in any trace that records its thread, and records into the
process-wide :class:`Trace` ``TRACE``, which counts the spans of each name.
:func:`span` is the call of the serving path: off, it costs one read of a
global bool, creates no CUDA event and makes no sync.  (Kernel launches are
counted, always, by ``treedetection_tpu_torch.build.launch_counts``.)

``TRACE`` also keeps one record per batch forward (:func:`trace_batch`):
its queue and host seconds, the count and seconds of its ``sync.<site>``
spans (every host<->device sync of the forward sits in one), the seconds
of each span inside it, and the device milliseconds of the stages the
caller times (:class:`StageMarks`), from CUDA events read by ``query()``
when a later batch starts and the rest by :func:`trace_snapshot`.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

# per-batch records kept while tracing is on, the newest last
MAX_BATCHES = 4096
SYNC_PREFIX = "sync."
_OFF = contextlib.nullcontext()


def tracing() -> bool:
    """Whether a ``torch.profiler`` session runs anywhere in the process
    (the process-wide flag: the per-thread one reads False on every thread
    but the profiler's)."""
    return _autograd_profiler._is_profiler_enabled


class Span:
    """One timed block: its ``seconds`` on exit.  While tracing is on it
    also enters ``record_function(name)`` and records into ``TRACE`` and
    the thread's open batch record; a ``sync.<site>`` span counts there as
    one host<->device sync."""

    __slots__ = ("name", "seconds", "_t0", "_rf")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0
        self._rf = None

    def __enter__(self) -> "Span":
        if tracing():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._t0 = time.time()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = time.time() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
            TRACE.record_span(self.name, self.seconds)
        return False


class StageTimer:
    """Named wall-clock spans, logged at DEBUG like the reference's stage
    timing (reference ``detection.py:350-373``) and queryable afterwards."""

    def __init__(self, logger=None):
        self.logger = logger
        self.spans: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        s = Span(name)
        try:
            with s:
                yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) + s.seconds
            if self.logger:
                self.logger.debug(f"{name} took {s.seconds:.2f}s")

    def summary(self) -> str:
        total = sum(self.spans.values()) or 1e-12  # no spans yet -> 0%
        lines = [f"  {k}: {v:.2f}s ({v / total * 100:.0f}%)"
                 for k, v in sorted(self.spans.items(), key=lambda kv: -kv[1])]
        return f"Stage timing (total {total:.2f}s):\n" + "\n".join(lines)


def span(name: str, timed: bool = False):
    """A block named ``name``: a :class:`Span` while tracing is on, else
    nothing (one read of a global bool).  ``timed`` keeps the stopwatch
    on with tracing off, for a caller that reads ``.seconds`` itself."""
    if timed or tracing():
        return Span(name)
    return _OFF


# -- per-batch records ----------------------------------------------------------

class BatchRecord:
    """One batch forward while tracing is on.  ``queue``: seconds from its
    submission (:func:`queued`) to its start, None where the submission
    was not timed; ``forward``: its host seconds; ``syncs``/``sync``: the
    count and seconds of its ``sync.<site>`` spans; ``spans``: seconds per
    span name inside it; ``device_ms``: device milliseconds per timed stage
    (from the previous timed mark, or the forward's start, to its mark),
    empty on the CPU or until read."""

    def __init__(self, queue: Optional[float]):
        self.queue = queue
        self.forward: Optional[float] = None
        self.syncs = 0
        self.sync = 0.0
        self.spans: Dict[str, float] = {}
        # (mark, CUDA event), the forward's start first; None until a
        # chunk's StageMarks claims them
        self.events: Optional[List[Tuple[str, Any]]] = None
        self.device_ms: Dict[str, float] = {}
        self._lock = threading.Lock()

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.spans[name] = self.spans.get(name, 0.0) + seconds
            if name.startswith(SYNC_PREFIX):
                self.syncs += 1
                self.sync += seconds

    def claim_events(self) -> Optional[List[Tuple[str, Any]]]:
        """The list for this record's CUDA events, to the first caller (the
        first chunk to mark, over several devices); None to the others."""
        with self._lock:
            if self.events is not None:
                return None
            self.events = []
            return self.events

    def read_events(self, wait: bool) -> bool:
        """``device_ms`` from the events once they have passed: ``query()``
        only, or a wait on them with ``wait`` -> whether they are read (or
        never will be: a forward that marked none)."""
        events, self.events = self.events or [], None
        if len(events) < 2:
            return True
        last = events[-1][1]
        if not wait and not last.query():
            self.events = events
            return False
        last.synchronize()
        for (_, a), (stage, b) in zip(events, events[1:]):
            self.device_ms[stage] = a.elapsed_time(b)
        return True

    def as_dict(self) -> Dict[str, Any]:
        return {"queue": self.queue, "forward": self.forward,
                "syncs": self.syncs, "sync": self.sync,
                "spans": dict(self.spans), "device_ms": dict(self.device_ms)}


class Trace:
    """What the spans record while tracing is on (``TRACE``): seconds and
    counts per name, and the batch records, oldest first; thread-safe."""

    def __init__(self):
        self.spans: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.batches: deque = deque(maxlen=MAX_BATCHES)
        self.pending: deque = deque()     # records whose events are unread
        # per thread: .batch, the open batch record; .submitted, the
        # submission stamp of the forward it runs
        self.local = threading.local()
        self.lock = threading.Lock()

    def record_span(self, name: str, seconds: float) -> None:
        with self.lock:
            self.counts[name] = self.counts.get(name, 0) + 1
            self.spans[name] = self.spans.get(name, 0.0) + seconds
        record = getattr(self.local, "batch", None)
        if record is not None:
            record.add(name, seconds)

    def finish(self, record: BatchRecord) -> None:
        with self.lock:
            self.batches.append(record)
            if record.events:
                self.pending.append(record)

    def read_pending(self, wait: bool) -> None:
        """Read the device stage times of the records whose events have
        passed, in stream order: the first not passed stops a read without
        ``wait``."""
        while True:
            with self.lock:
                if not self.pending:
                    return
                record = self.pending[0]
            if not record.read_events(wait):
                return
            with self.lock:
                if self.pending and self.pending[0] is record:
                    self.pending.popleft()

    def snapshot(self) -> Dict[str, Any]:
        self.read_pending(wait=True)
        with self.lock:
            return {"spans": dict(self.spans), "counts": dict(self.counts),
                    "batches": [r.as_dict() for r in self.batches]}

    def reset(self) -> None:
        with self.lock:
            self.spans.clear()
            self.counts.clear()
            self.batches.clear()
            self.pending.clear()


TRACE = Trace()


def queued(fn):
    """``fn`` stamped with the time of this call, the submission, so that
    the batch record it opens (:func:`trace_batch`) knows its queue."""
    submitted = time.time()

    def run(*args, **kwargs):
        TRACE.local.submitted = submitted
        try:
            return fn(*args, **kwargs)
        finally:
            TRACE.local.submitted = None
    return run


@contextlib.contextmanager
def _batch_on(name: str) -> Iterator[BatchRecord]:
    start = time.time()
    submitted = getattr(TRACE.local, "submitted", None)
    TRACE.local.submitted = None
    TRACE.read_pending(wait=False)
    record = BatchRecord(None if submitted is None else start - submitted)
    with _attach_on(record), Span(name) as s:
        yield record
    record.forward = s.seconds
    TRACE.finish(record)


def trace_batch(name: str):
    """Open a batch record (one span ``name`` around the forward) while
    tracing is on; yields it, or None with tracing off."""
    return _batch_on(name) if tracing() else _OFF


@contextlib.contextmanager
def _attach_on(record: BatchRecord) -> Iterator[None]:
    outer = getattr(TRACE.local, "batch", None)
    TRACE.local.batch = record
    try:
        yield
    finally:
        TRACE.local.batch = outer


def attach(record: Optional[BatchRecord]):
    """Count this thread's spans into ``record`` (a chunk of a batch run
    on another device's thread); nothing when ``record`` is None."""
    return _OFF if record is None else _attach_on(record)


class StageMarks:
    """The ``mark`` hook of a forward while tracing is on: one span per
    stage (``<prefix>.<stage>``, from the previous mark to this one), and
    on the card CUDA events at the start and at the marks of the ``timed``
    stages into the thread's batch record (:meth:`BatchRecord.claim_events`).
    Use as a context manager around the forward; it closes the open stage
    span if the forward raises."""

    def __init__(self, stages: Sequence[str], prefix: str,
                 device: torch.device, timed: Sequence[str] = ()):
        self.stages = list(stages)
        self.prefix = prefix
        self.timed = frozenset(timed)
        record = getattr(TRACE.local, "batch", None)
        self.events = None
        if device.type == "cuda" and record is not None and self.timed:
            self.events = record.claim_events()
        self._open: Optional[Span] = None

    def _event(self, stage: str) -> None:
        if self.events is not None:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events.append((stage, e))

    def _next(self, i: int) -> None:
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None
        if i < len(self.stages):
            self._open = Span(f"{self.prefix}.{self.stages[i]}").__enter__()

    def __enter__(self) -> "StageMarks":
        self._event("start")
        self._next(0)
        return self

    def __call__(self, stage: str) -> None:
        if stage in self.timed:
            self._event(stage)
        self._next(self.stages.index(stage) + 1)

    def __exit__(self, *exc) -> bool:
        if self._open is not None:
            self._open.__exit__(*exc)
            self._open = None
        return False


def stage_marks(stages: Sequence[str], prefix: str, device: torch.device,
                timed: Sequence[str] = ()):
    """A :class:`StageMarks` while tracing is on, which enters as the
    ``mark`` hook; else nothing, which enters as None (no hook)."""
    if tracing():
        return StageMarks(stages, prefix, device, timed)
    return _OFF


def trace_snapshot() -> Dict[str, Any]:
    """``TRACE`` now: seconds and counts per name, and the batch records
    (``BatchRecord.as_dict``), oldest first, their device stage times read
    (a wait on events not yet passed)."""
    return TRACE.snapshot()


def trace_reset() -> None:
    """Empty ``TRACE``."""
    TRACE.reset()


def _all_threads_config():
    """``torch.profiler``'s experimental config that records every thread,
    None where the installed torch lacks it."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile a block with ``torch.profiler`` (CPU activity, and CUDA's
    where a card is visible; every thread, where the installed torch can)
    and write its Chrome trace to ``<log_dir>/trace_<pid>_<time>.json`` on
    exit; no-op when ``log_dir`` is falsy.  The device threads' spans land
    on the same clock as the kernels."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    every_thread = _all_threads_config()
    extra = {} if every_thread is None else {
        "experimental_config": every_thread}
    with profile(activities=activities, **extra) as prof:
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
