"""Device milliseconds per traced batch of the attention kernel
(``relpos_attention_kernel``, all 24 blocks) in the ViTDet stream."""

from metrics.relpos_attn_roofline import KERNEL


def read(records):
    trace, traced = records.get("trace"), records.get("traced")
    if not trace or not traced or not traced["batches"]:
        return None
    busy = sum(s for name, s in trace["ops"].items() if KERNEL in name)
    return 1e3 * busy / traced["batches"] if busy > 0 else None
