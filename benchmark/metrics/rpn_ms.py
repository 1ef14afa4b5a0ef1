"""Milliseconds from the start of the forward to the end of its ``rpn``
stage (backbone, FPN and RPN head), from the CUDA events that
``MaskRCNN.forward`` records through ``mark`` on the Predictor's own model,
the median over the batches marked after the window."""

import statistics


def read(records):
    runs = records.get("stage_ms")
    if not runs:
        return None
    return statistics.median(r[0] for r in runs)
