"""Median host milliseconds of a served batch's forward on the Predictor's
device thread: its ``predictor.forward`` span, from pinning the batch to
the last device->host copy enqueued (preprocess, every stage's launches
and the syncs inside them), over the traced segment's batch records
(``treedetection_tpu_torch.utils.profiling.trace_snapshot``); None where
the program keeps no such records."""

import statistics


def read(records):
    try:
        from treedetection_tpu_torch.utils.profiling import trace_snapshot
    except ImportError:
        return None
    values = [b["forward"] for b in trace_snapshot()["batches"]
              if b.get("forward") is not None]
    return 1e3 * statistics.median(values) if values else None
