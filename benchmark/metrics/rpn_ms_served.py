"""Median device milliseconds of the served batches' ``rpn`` stage
(backbone, FPN and RPN head): CUDA events that the Predictor records at
the forward's start and at its ``rpn`` mark, on the traced segment's
batches as the stream serves them (two in flight), from the batch records
of ``treedetection_tpu_torch.utils.profiling.trace_snapshot``; None where
the program keeps no such records."""

import statistics


def read(records):
    try:
        from treedetection_tpu_torch.utils.profiling import trace_snapshot
    except ImportError:
        return None
    values = [b["device_ms"]["rpn"] for b in trace_snapshot()["batches"]
              if "rpn" in b.get("device_ms", {})]
    return statistics.median(values) if values else None
