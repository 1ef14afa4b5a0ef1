"""The ROIAlign pooler's share of its roofline in the traced segment: the
least time that the chip could pool in (``flops.roi_align_work``: the box
pool's post-NMS proposals at 7x7 and the mask pool's detection slots at
14x14, 256 channels, bfloat16 outputs, every traced forward), over the
device time of the pooler's kernels.  The traced run does not see the
proposals' boxes, so the bytes are the outputs alone: the feature cells that
the samples touch are not counted, and the share reads low by that much."""

import flops

# substrings of the pooler kernels' names (K1 flat, K5 per-level, K6
# resident; each in float32 and bfloat16)
KERNELS = ("roi_pool_flat", "roi_pool_levels", "roi_pool_resident")


def read(records):
    trace, traced = records.get("trace"), records.get("traced")
    if not trace or not traced:
        return None
    busy = sum(s for name, s in trace["ops"].items()
               if any(k in name for k in KERNELS))
    if busy <= 0:
        return None
    m = records["model"]
    c = int(m["fpn_channels"])
    tiles = traced["batches"] * records["batch_size"]
    box = flops.roi_align_work(tiles * int(m["rpn_post_nms_topk"]),
                               int(m["box_pool"]), c, 2)
    mask = flops.roi_align_work(tiles * int(m["max_detections"]),
                                int(m["mask_pool"]), c, 2)
    least = sum(flops.roofline_seconds(f, b, "bfloat16") for f, b in
                (box, mask))
    return 100.0 * least / busy
