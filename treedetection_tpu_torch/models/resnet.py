"""ResNet-50/101 + FPN backbone, NCHW inside, with frozen or batch norm.

Counterpart of ``treedetection_tpu/models/resnet.py``: caffe-style
bottlenecks with the stride on the first 1x1 conv, a 3x3/2 stem max-pool,
FPN with 256 channels, nearest top-down upsampling and P6 as a stride-2
subsample of P5.  The norm is ``"frozen"`` (``x * scale + bias``: serving,
and fine-tuning converted checkpoints) or ``"batch"`` (from-scratch
training: statistics of the batch, in float32, with running averages kept
only for the fold at save; ``models.convert.fold_batch_stats`` turns them
into the frozen layout).  Both keep their affine as the parameters
``norm.scale`` and ``norm.bias``, the running averages are the buffers
``norm.mean`` and ``norm.var``.  ``remat`` recomputes each bottleneck in
the backward pass (``torch.utils.checkpoint``).

Over several processes (``train.train.make_sharded_train_step``) batch norm
takes its statistics over the global batch, as Flax's does under ``jit``
over a mesh: :func:`set_sync_group` gives every :class:`BatchNorm` a
``torch.distributed`` group as module state, so that remat's recomputation
in the backward pass, which runs outside any block of the forward,
synchronises as the forward did.

The public interface keeps the JAX package's NHWC layout: :class:`ResNetFPN`
takes (B, H, W, 3) and returns [P2..P6] as (B, H_l, W_l, 256).  Inside, the
tensors are NCHW in channels_last memory, so both conversions are free views.
No W-folding and no scanned blocks: those exist for the TPU's MXU and
compiler.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from treedetection_tpu_torch.models.layers import Conv2d

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
BN_MOMENTUM = 0.9     # Flax's convention: running = m * running + (1-m) * batch
BN_EPS = 1e-5


class FrozenBN(nn.Module):
    """Inference-mode batch norm folded to ``y = x * scale + bias``, in the
    input's dtype."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        return (x * self.scale.to(dt)[:, None, None]
                + self.bias.to(dt)[:, None, None])


# the collector of the forward that runs under collect_batch_stats(), if any
_STATS: List[Dict["BatchNorm", Tuple[torch.Tensor, torch.Tensor]]] = []


@contextlib.contextmanager
def collect_batch_stats() -> Iterator[Dict["BatchNorm", Tuple[torch.Tensor,
                                                               torch.Tensor]]]:
    """Collect each :class:`BatchNorm`'s batch (mean, biased variance) of
    the forward run inside the block, the first call per module only.  The
    backward's recomputation under ``remat`` runs outside the block and adds
    nothing, so the running statistics move once per step, as Flax's
    functional remat moves them."""
    stats: Dict[BatchNorm, Tuple[torch.Tensor, torch.Tensor]] = {}
    _STATS.append(stats)
    try:
        yield stats
    finally:
        _STATS.pop()


class _AllReduceSum(torch.autograd.Function):
    """All-reduce (SUM) over ``group`` whose gradient is the all-reduce of
    the upstream gradients (``torch.distributed.nn.functional.all_reduce``
    computes the same and is deprecated)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class BatchNorm(nn.Module):
    """Batch norm on the batch's statistics, always, in float32 at least
    (the output too, as Flax's ``nn.BatchNorm(dtype=float32)``).  The running averages
    follow Flax: momentum 0.9 and the BIASED batch variance; they move only
    through :func:`updated_batch_stats`.

    With ``sync_group`` set (:func:`set_sync_group`) to a group of more than
    one process, the statistics are those of the global batch: each
    process all-reduces its channel sums of ``x`` and ``x**2`` in one
    stacked tensor, and takes Flax's fast variance ``E[x**2] - E[x]**2``
    (clamped at 0) over every process's equal chunk.  The all-reduce's
    gradient is the all-reduce of the upstream gradients, so the backward
    pass exchanges them too.  Without a group, or with a group of one,
    the layer is ``F.batch_norm``."""

    def __init__(self, features: int, zero_gamma: bool = False):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(features) if zero_gamma
                                  else torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.sync_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, torch.float32)
        x = x.to(dt)
        c = x.shape[1]
        n = x.numel() // c
        stats = _STATS[-1] if _STATS else None
        record = stats is not None and self not in stats
        group = self.sync_group
        if group is not None and dist.get_world_size(group) > 1:
            y, mean, var = self._synced(x, group, n * dist.get_world_size(
                group))
        else:
            # momentum 1 leaves exactly the batch's mean and unbiased
            # variance in the two buffers: no second pass over x.  The call
            # is the same whether or not it records, so remat's
            # recomputation saves the same tensors as the first forward.
            mean = torch.zeros(c, dtype=dt, device=x.device)
            var = torch.zeros(c, dtype=dt, device=x.device)
            y = F.batch_norm(x, mean, var, self.scale.to(dt),
                             self.bias.to(dt), training=True, momentum=1.0,
                             eps=BN_EPS)
            if record:
                var = var * ((n - 1) / n)
        if record:
            stats[self] = (mean, var)
        return y

    def _synced(self, x: torch.Tensor, group, n_global: int):
        """-> (y, mean, biased var) over the group's global batch, as Flax
        normalizes: ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""
        dt = x.dtype
        sums = _AllReduceSum.apply(
            torch.stack([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3))]),
            group)
        mean = sums[0] / n_global
        var = torch.clamp(sums[1] / n_global - mean * mean, min=0.0)
        mul = torch.rsqrt(var + BN_EPS) * self.scale.to(dt)
        y = ((x - mean[:, None, None]) * mul[:, None, None]
             + self.bias.to(dt)[:, None, None])
        return y, mean.detach(), var.detach()


def set_sync_group(model: nn.Module, group) -> None:
    """Set ``group`` (a ``torch.distributed`` process group, or None) as
    the statistics group of every :class:`BatchNorm` in ``model``."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.sync_group = group


def updated_batch_stats(model: nn.Module, stats) -> Dict[str, torch.Tensor]:
    """The running statistics after one step, as state-dict entries
    (``<module>.mean`` / ``<module>.var``), from what
    :func:`collect_batch_stats` gathered."""
    out = {}
    with torch.no_grad():
        for name, m in model.named_modules():
            if m in stats:
                mean, var = stats[m]
                out[f"{name}.mean"] = (BN_MOMENTUM * m.mean
                                       + (1.0 - BN_MOMENTUM) * mean)
                out[f"{name}.var"] = (BN_MOMENTUM * m.var
                                      + (1.0 - BN_MOMENTUM) * var)
    return out


class ConvBN(nn.Module):
    """Conv (no bias, same padding) + norm (+ ReLU)."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True, norm: str = "frozen",
                 zero_gamma: bool = False):
        super().__init__()
        self.conv = Conv2d(in_features, features, kernel, stride=stride,
                           padding=(kernel - 1) // 2, bias=False)
        if norm == "batch":
            self.norm = BatchNorm(features, zero_gamma=zero_gamma)
        elif norm == "frozen":
            self.norm = FrozenBN(features)
        else:
            raise ValueError(f"unknown norm {norm!r}")
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(self.conv(x))
        return F.relu(x) if self.relu else x


class Bottleneck(nn.Module):
    """Caffe-style bottleneck: the stride lives on the first 1x1 conv; with
    batch norm ``conv3``'s scale starts at 0 (each block starts as the
    identity)."""

    def __init__(self, in_features: int, width: int, out_features: int,
                 stride: int = 1, norm: str = "frozen"):
        super().__init__()
        self.shortcut = None
        if in_features != out_features or stride != 1:
            self.shortcut = ConvBN(in_features, out_features, kernel=1,
                                   stride=stride, relu=False, norm=norm)
        self.conv1 = ConvBN(in_features, width, kernel=1, stride=stride,
                            norm=norm)
        self.conv2 = ConvBN(width, width, kernel=3, norm=norm)
        self.conv3 = ConvBN(width, out_features, kernel=1, relu=False,
                            norm=norm, zero_gamma=norm == "batch")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        y = self.conv3(self.conv2(self.conv1(x)))
        return F.relu(y + shortcut.to(y.dtype))


class ResNet(nn.Module):
    """Stem + res2..res5; ``forward`` -> [C2, C3, C4, C5] (strides 4..32)."""

    def __init__(self, depth: int = 101, norm: str = "frozen",
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.stem = ConvBN(3, 64, kernel=7, stride=2, norm=norm)
        in_f, width, out_f = 64, 64, 256
        for stage, n_blocks in enumerate(STAGE_BLOCKS[depth]):
            blocks = [Bottleneck(in_f, width, out_f,
                                 stride=1 if stage == 0 else 2, norm=norm)]
            blocks += [Bottleneck(out_f, width, out_f, norm=norm)
                       for _ in range(n_blocks - 1)]
            self.add_module(f"res{stage + 2}", nn.Sequential(*blocks))
            in_f, width, out_f = out_f, width * 2, out_f * 2

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.max_pool2d(self.stem(x), kernel_size=3, stride=2, padding=1)
        remat = self.remat and torch.is_grad_enabled()
        outs = []
        for s in range(2, 6):
            for block in getattr(self, f"res{s}"):
                x = (checkpoint(block, x, use_reentrant=False,
                                preserve_rng_state=False) if remat
                     else block(x))
            outs.append(x)
        return outs


class FPN(nn.Module):
    """Lateral 1x1 + output 3x3 convs, nearest top-down upsampling,
    P6 = stride-2 subsample of P5."""

    def __init__(self, in_features: Sequence[int] = (256, 512, 1024, 2048),
                 features: int = 256):
        super().__init__()
        for i, c in enumerate(in_features):
            self.add_module(f"lateral{i + 2}", Conv2d(c, features, 1))
            self.add_module(f"output{i + 2}",
                            Conv2d(features, features, 3, padding=1))

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

    def __init__(self, depth: int = 101, fpn_features: int = 256,
                 norm: str = "frozen", remat: bool = False):
        super().__init__()
        self.bottom_up = ResNet(depth, norm=norm, remat=remat)
        self.fpn = FPN(features=fpn_features)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        feats = self.fpn(self.bottom_up(x))
        return [f.permute(0, 2, 3, 1) for f in feats]
