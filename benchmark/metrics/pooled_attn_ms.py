"""Device milliseconds per traced batch of the pooling attention kernel
(``relpos_attention_kernel_pooled``, all ten blocks) in the MViTv2
stream."""

from metrics.pooled_attn_roofline import KERNEL


def read(records):
    trace, traced = records.get("trace"), records.get("traced")
    if not trace or not traced or not traced["batches"]:
        return None
    busy = sum(s for name, s in trace["ops"].items() if KERNEL in name)
    return 1e3 * busy / traced["batches"] if busy > 0 else None
