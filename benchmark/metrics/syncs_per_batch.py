"""Median count of host<->device syncs per served batch (its
``sync.<site>`` spans), over the traced segment's batch records
(``treedetection_tpu_torch.utils.profiling.trace_snapshot``); None where
the program keeps no such records."""

import statistics


def read(records):
    try:
        from treedetection_tpu_torch.utils.profiling import trace_snapshot
    except ImportError:
        return None
    values = [b["syncs"] for b in trace_snapshot()["batches"]
              if b.get("syncs") is not None]
    return float(statistics.median(values)) if values else None
