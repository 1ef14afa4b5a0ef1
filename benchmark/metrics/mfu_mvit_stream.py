"""The window's MViTv2 operations (``flops_mvit.forward_flops`` per tile,
every tile of every batch served) over its seconds, as a share of the
bfloat16 peak."""

import flops
import flops_mvit


def read(records):
    n = records.get("batches")
    if not n:
        return None
    work = n * records["batch_size"] * flops_mvit.forward_flops(
        records["model"])
    return 100.0 * work / records["window_s"] / \
        flops.PEAKS["flops_per_s"]["bfloat16"]
