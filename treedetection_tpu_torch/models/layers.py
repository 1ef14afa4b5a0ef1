"""Convolution and dense layers with a compute dtype, and Flax's initialiser.

Flax's ``dtype`` keeps a layer's parameters in float32 and casts them, with
the input, to the compute dtype at each call.  Training under ``bf16`` needs
that: float32 parameters and optimizer state, bfloat16 convolutions.  The
layers here compute in ``compute_dtype`` when it is set and in their
weight's dtype otherwise, so a model moved to bfloat16 for serving
(``model.to(torch.bfloat16)``) runs as before.

:func:`lecun_normal_` draws Flax's default kernel initialiser
(``variance_scaling(1.0, "fan_in", "truncated_normal")``) from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _dtype_of(layer) -> torch.dtype:
    return layer.compute_dtype or layer.weight.dtype


def _cast(t: Optional[torch.Tensor], dt: torch.dtype):
    return None if t is None else t.to(dt)


class Conv2d(nn.Conv2d):
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _dtype_of(self)
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  _cast(self.bias, dt))


class ConvTranspose2d(nn.ConvTranspose2d):
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _dtype_of(self)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  _cast(self.bias, dt), self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation)


class Linear(nn.Linear):
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _dtype_of(self)
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


COMPUTE_LAYERS = (Conv2d, ConvTranspose2d, Linear)


def set_compute_dtype(module: nn.Module, dtype: Optional[torch.dtype]) -> None:
    """Set (or with None clear) the compute dtype of every layer below
    ``module``."""
    for m in module.modules():
        if isinstance(m, COMPUTE_LAYERS):
            m.compute_dtype = dtype


# standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """Fill ``weight`` with Flax's ``lecun_normal``: a normal truncated at
    two standard deviations, scaled to variance ``1 / fan_in``, drawn by the
    inverse CDF as ``jax.random.truncated_normal`` does."""
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    with torch.no_grad():
        u = torch.empty(weight.shape, dtype=torch.float64).uniform_(
            lo, hi, generator=generator)
        x = torch.erfinv(u) * math.sqrt(2) * (
            math.sqrt(1.0 / fan_in) / _TRUNC_STD)
        weight.copy_(x.to(weight.dtype))


def init_like_flax(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every conv, deconv and dense layer below ``module`` as
    Flax does: kernels ``lecun_normal`` over their fan-in, biases zero."""
    for m in module.modules():
        if isinstance(m, ConvTranspose2d):     # weight (in, out, kh, kw)
            fan_in = m.weight.shape[0] * m.weight.shape[2] * m.weight.shape[3]
        elif isinstance(m, (Conv2d, Linear)):  # weight (out, in, ...)
            fan_in = m.weight[0].numel()
        else:
            continue
        lecun_normal_(m.weight, fan_in, generator)
        if m.bias is not None:
            with torch.no_grad():
                m.bias.zero_()
