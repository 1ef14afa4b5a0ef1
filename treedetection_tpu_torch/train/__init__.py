"""Training: Mask R-CNN losses, the train step, presets and the training
loop — counterpart of ``treedetection_tpu/train``."""

from treedetection_tpu_torch.train.losses import mask_rcnn_losses  # noqa: F401
from treedetection_tpu_torch.train.train import (  # noqa: F401
    TrainConfig, make_train_step, train_model, PRESETS)
