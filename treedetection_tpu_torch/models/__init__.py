"""Mask R-CNN (ResNet-FPN) in PyTorch — counterpart of
``treedetection_tpu/models``."""

from treedetection_tpu_torch.models.mask_rcnn import (  # noqa: F401
    MaskRCNN, MaskRCNNConfig, ModelOutput)
from treedetection_tpu_torch.models.resnet import ResNetFPN  # noqa: F401
