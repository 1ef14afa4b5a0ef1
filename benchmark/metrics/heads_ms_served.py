"""Median device milliseconds of the served batches from the ``rpn`` mark
to the ``maskhead`` mark (proposals, box pool, box head, NMS, mask pool,
mask head): the same CUDA events as ``rpn_ms.served``, on the traced
segment's batches, from the batch records of
``treedetection_tpu_torch.utils.profiling.trace_snapshot``; None where the
program keeps no such records."""

import statistics


def read(records):
    try:
        from treedetection_tpu_torch.utils.profiling import trace_snapshot
    except ImportError:
        return None
    values = [b["device_ms"]["maskhead"] for b in trace_snapshot()["batches"]
              if "maskhead" in b.get("device_ms", {})]
    return statistics.median(values) if values else None
