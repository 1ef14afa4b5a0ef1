"""Median host milliseconds per served batch inside the forward's
host<->device syncs (its ``sync.<site>`` spans: NMS convergence checks,
the pooler's value checks and copies of host values to the card), over
the traced segment's batch records
(``treedetection_tpu_torch.utils.profiling.trace_snapshot``); None where
the program keeps no such records."""

import statistics


def read(records):
    try:
        from treedetection_tpu_torch.utils.profiling import trace_snapshot
    except ImportError:
        return None
    values = [b["sync"] for b in trace_snapshot()["batches"]
              if b.get("sync") is not None]
    return 1e3 * statistics.median(values) if values else None
