"""The attention kernel's share of its roofline in the traced segment of
the ViTDet stream: the least time in which the card could do the traced
batches' attention (``flops_vitdet.attention_work`` per launch: every
block of every traced forward, the windowed and the global ones, each the
larger of its operations over the bfloat16 peak and its bytes over the
memory's), over the kernel's device time."""

import flops
import flops_vitdet

KERNEL = "relpos_attention_kernel"


def read(records):
    trace, traced = records.get("trace"), records.get("traced")
    if not trace or not traced:
        return None
    busy = sum(s for name, s in trace["ops"].items() if KERNEL in name)
    if busy <= 0:
        return None
    m = records["model"]
    work = flops_vitdet.attention_work(m, records["batch_size"])
    launches = flops_vitdet.attention_launches(m)
    least = sum(n * flops.roofline_seconds(*work[kind], "bfloat16")
                for kind, n in launches.items())
    return 100.0 * traced["batches"] * least / busy
