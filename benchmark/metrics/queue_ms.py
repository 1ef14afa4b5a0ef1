"""Median milliseconds a served batch waits on the Predictor's device
thread: from its submission (``Predictor._dispatch.submit``) to the start
of its forward, over the traced segment's batch records
(``treedetection_tpu_torch.utils.profiling.trace_snapshot``); None where
the program keeps no such records."""

import statistics


def read(records):
    try:
        from treedetection_tpu_torch.utils.profiling import trace_snapshot
    except ImportError:
        return None
    values = [b["queue"] for b in trace_snapshot()["batches"]
              if b.get("queue") is not None]
    return 1e3 * statistics.median(values) if values else None
