"""Tensor ops of the port: boxes, NMS, ROIAlign, masks, image transforms
and NDVI (counterpart of ``treedetection_tpu/ops``); hand-written kernels
live in ``ops.kernels``.  ``ops.roi_align`` is the submodule of that name,
not the JAX package's function: that is ``ops.roi_align.roi_align``."""

from treedetection_tpu_torch.ops.boxes import (  # noqa: F401
    box_iou_matrix, apply_deltas, encode_deltas, clip_boxes, box_area,
)
from treedetection_tpu_torch.ops.nms import batched_nms, nms_mask  # noqa: F401
from treedetection_tpu_torch.ops.roi_align import multilevel_roi_align  # noqa: F401
from treedetection_tpu_torch.ops.image import (  # noqa: F401
    resize_bilinear, normalize_bgr, ndvi_from_rgbi, rgbi_to_model_input,
)
from treedetection_tpu_torch.ops.masks import paste_masks_in_image  # noqa: F401
