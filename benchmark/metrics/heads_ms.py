"""Milliseconds from the end of the forward's ``rpn`` stage to the end of
its ``maskhead`` stage (proposals, box pool, box head, NMS, mask pool, mask
head), from the same CUDA events as ``rpn_ms``, the median over the marked
batches."""

import statistics


def read(records):
    runs = records.get("stage_ms")
    if not runs:
        return None
    return statistics.median(r[1] for r in runs)
