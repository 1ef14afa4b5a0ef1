"""Arithmetic that several readers share."""

import flops


def idle_share(records):
    """Per cent of the traced segment with nothing running on the card."""
    trace = records.get("trace")
    if not trace or trace["busy_s"] <= 0 or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def mfu(records):
    """Per cent of the chip's bfloat16 peak that the window's forwards
    reach: their operations (``flops.forward_flops`` per tile, every tile
    of every batch) over the window's seconds."""
    n = records.get("forwards", records.get("batches"))
    if not n:
        return None
    work = n * records["batch_size"] * flops.forward_flops(records["model"])
    return 100.0 * work / records["window_s"] / \
        flops.PEAKS["flops_per_s"]["bfloat16"]
