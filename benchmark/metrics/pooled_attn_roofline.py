"""The pooling attention kernel's share of its roofline in the traced
segment of the MViTv2 stream: the least time in which the card could do
the traced batches' attention (``flops_mvit.attention_work`` per launch:
every block of every traced forward, each the larger of its operations
over the bfloat16 peak and its bytes over the memory's), over the device
time of the kernels whose name holds ``relpos_attention_kernel_pooled``."""

import flops_mvit

KERNEL = "relpos_attention_kernel_pooled"


def read(records):
    trace, traced = records.get("trace"), records.get("traced")
    if not trace or not traced:
        return None
    busy = sum(s for name, s in trace["ops"].items() if KERNEL in name)
    if busy <= 0:
        return None
    least = flops_mvit.least_seconds(records["model"], records["batch_size"])
    return 100.0 * traced["batches"] * least / busy
