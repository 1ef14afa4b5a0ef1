"""Tensor ops of the port: boxes, NMS, ROIAlign, image transforms
(counterpart of ``treedetection_tpu/ops``); hand-written kernels live in
``ops.kernels``."""
