"""ResNet-50/101 + FPN backbone (frozen BN), NCHW inside.

Counterpart of ``treedetection_tpu/models/resnet.py``: caffe-style
bottlenecks with the stride on the first 1x1 conv, frozen batch-norm as
``x * scale + bias``, a 3x3/2 stem max-pool, FPN with 256 channels, nearest
top-down upsampling and P6 as a stride-2 subsample of P5.

The public interface keeps the JAX package's NHWC layout: :class:`ResNetFPN`
takes (B, H, W, 3) and returns [P2..P6] as (B, H_l, W_l, 256).  Inside, the
tensors are NCHW in channels_last memory, so both conversions are free views.
No W-folding and no scanned blocks: those exist for the TPU's MXU and
compiler.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class FrozenBN(nn.Module):
    """Inference-mode batch norm folded to ``y = x * scale + bias``; the two
    vectors are buffers, not parameters."""

    def __init__(self, features: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale[:, None, None] + self.bias[:, None, None]


class ConvBN(nn.Module):
    """Conv (no bias, same padding) + FrozenBN (+ ReLU)."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, kernel, stride=stride,
                              padding=(kernel - 1) // 2, bias=False)
        self.norm = FrozenBN(features)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(self.conv(x))
        return F.relu(x) if self.relu else x


class Bottleneck(nn.Module):
    """Caffe-style bottleneck: the stride lives on the first 1x1 conv."""

    def __init__(self, in_features: int, width: int, out_features: int,
                 stride: int = 1):
        super().__init__()
        self.shortcut = None
        if in_features != out_features or stride != 1:
            self.shortcut = ConvBN(in_features, out_features, kernel=1,
                                   stride=stride, relu=False)
        self.conv1 = ConvBN(in_features, width, kernel=1, stride=stride)
        self.conv2 = ConvBN(width, width, kernel=3)
        self.conv3 = ConvBN(width, out_features, kernel=1, relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        y = self.conv3(self.conv2(self.conv1(x)))
        return F.relu(y + shortcut)


class ResNet(nn.Module):
    """Stem + res2..res5; ``forward`` -> [C2, C3, C4, C5] (strides 4..32)."""

    def __init__(self, depth: int = 101):
        super().__init__()
        self.stem = ConvBN(3, 64, kernel=7, stride=2)
        in_f, width, out_f = 64, 64, 256
        for stage, n_blocks in enumerate(STAGE_BLOCKS[depth]):
            blocks = [Bottleneck(in_f, width, out_f,
                                 stride=1 if stage == 0 else 2)]
            blocks += [Bottleneck(out_f, width, out_f)
                       for _ in range(n_blocks - 1)]
            self.add_module(f"res{stage + 2}", nn.Sequential(*blocks))
            in_f, width, out_f = out_f, width * 2, out_f * 2

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.max_pool2d(self.stem(x), kernel_size=3, stride=2, padding=1)
        outs = []
        for s in range(2, 6):
            x = getattr(self, f"res{s}")(x)
            outs.append(x)
        return outs


class FPN(nn.Module):
    """Lateral 1x1 + output 3x3 convs, nearest top-down upsampling,
    P6 = stride-2 subsample of P5."""

    def __init__(self, in_features: Sequence[int] = (256, 512, 1024, 2048),
                 features: int = 256):
        super().__init__()
        for i, c in enumerate(in_features):
            self.add_module(f"lateral{i + 2}", nn.Conv2d(c, features, 1))
            self.add_module(f"output{i + 2}",
                            nn.Conv2d(features, features, 3, padding=1))

    def forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [getattr(self, f"lateral{i + 2}")(c)
                    for i, c in enumerate(inputs)]
        for i in range(len(laterals) - 2, -1, -1):
            # nearest x2 == repeating each pixel twice along H and W
            up = F.interpolate(laterals[i + 1], scale_factor=2, mode="nearest")
            laterals[i] = laterals[i] + up
        outs = [getattr(self, f"output{i + 2}")(lat)
                for i, lat in enumerate(laterals)]
        outs.append(outs[-1][:, :, ::2, ::2])
        return outs


class ResNetFPN(nn.Module):
    """(B, H, W, 3) NHWC -> [P2, P3, P4, P5, P6], each (B, H_l, W_l, 256)."""

    def __init__(self, depth: int = 101, fpn_features: int = 256):
        super().__init__()
        self.bottom_up = ResNet(depth)
        self.fpn = FPN(features=fpn_features)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        feats = self.fpn(self.bottom_up(x))
        return [f.permute(0, 2, 3, 1) for f in feats]
