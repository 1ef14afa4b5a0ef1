"""The ResNet backbone's frozen norms with their ReLUs and shortcut adds as
one pass per conv: the CUDA kernel, its wrappers and its plain versions.

Replaces no TPU kernel: the JAX package leaves the norms to XLA, which fuses
them into the convolutions.  A frozen norm is ``y * scale + bias`` in the
input's dtype (:func:`frozen_norm_reference`, what ``models.resnet.FrozenBN``
computes).  Two places in a bottleneck network finish a conv with it:

* :func:`frozen_norm_relu` -- ``relu(norm(y))``: the stem, and ``conv1`` and
  ``conv2`` of every bottleneck (``models.resnet.ConvBN`` with its ReLU);
* :func:`frozen_norm_tail` -- ``relu(norm(y) + shortcut)``: a bottleneck's
  ``conv3`` with its shortcut, the block's input or, with ``shortcut_scale``
  and ``shortcut_bias``, the norm of the projection shortcut conv's output
  (``models.resnet.Bottleneck``).

Eager PyTorch runs each multiply, add and ReLU as a pass of its own over
the map; ``csrc/frozen_norm.cu`` (``LIBRARY``, built, bound and launched by
``treedetection_tpu_torch.build``) reads the conv's output, and the
shortcut, once and writes the result once, in place of the conv's output.
It rounds where the plain versions round, so on the card its output is
bit-equal to theirs, in bfloat16 and in float32.  Its source says what bounds
it and how its design answers.  For a CUDA tensor the wrappers launch it or
raise (bfloat16 or float32 maps in channels_last memory, whose channels fill
16-byte vectors, every tensor on a 16-byte boundary); only a tensor on the
CPU takes the plain versions.  Launches count on ``frozen_norm`` (the
ReLU form) and ``frozen_norm.tail``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from treedetection_tpu_torch.build import cuda_library, launch

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = cuda_library("frozen_norm", {
    "td_frozen_norm": [_P] * 7 + [_L, _I, _I, _P]})

DTYPES = (torch.bfloat16, torch.float32)


def frozen_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """``x * scale + bias`` over the channels of an NCHW map, in ``x``'s
    dtype: the frozen norm as eager PyTorch computes it."""
    dt = x.dtype
    return x * scale.to(dt)[:, None, None] + bias.to(dt)[:, None, None]


def frozen_norm_relu_reference(y: torch.Tensor, scale: torch.Tensor,
                               bias: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`frozen_norm_relu`."""
    return F.relu(frozen_norm_reference(y, scale, bias))


def frozen_norm_tail_reference(
        y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
        shortcut: torch.Tensor, shortcut_scale: Optional[torch.Tensor] = None,
        shortcut_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of :func:`frozen_norm_tail`."""
    if shortcut_scale is not None:
        shortcut = frozen_norm_reference(shortcut, shortcut_scale,
                                         shortcut_bias)
    y = frozen_norm_reference(y, scale, bias)
    return F.relu(y + shortcut.to(y.dtype))


def frozen_norm_relu(y: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """``relu(y * scale + bias)`` of a conv's output ``y`` (N, C, H, W) and
    the norm's (C,) parameters.

    On the card: one launch, counted on ``frozen_norm``, that writes the
    result into ``y`` and returns it (nothing else may read ``y``).  Raises
    for what the kernel does not take; a tensor on the CPU takes
    :func:`frozen_norm_relu_reference`."""
    if y.device.type == "cpu":
        return frozen_norm_relu_reference(y, scale, bias)
    _launch(y, scale, bias, None, None, None, "frozen_norm")
    return y


def frozen_norm_tail(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     shortcut: torch.Tensor,
                     shortcut_scale: Optional[torch.Tensor] = None,
                     shortcut_bias: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """``relu(y * scale + bias + shortcut)``: a bottleneck's last conv output
    ``y`` (N, C, H, W) normed and added to ``shortcut`` (the block's input,
    of ``y``'s shape and dtype), or to ``shortcut * shortcut_scale +
    shortcut_bias`` where both are given (the projection shortcut conv's
    output and its norm).

    On the card: one launch, counted on ``frozen_norm.tail``, that writes
    the result into ``y`` and returns it.  Raises for what the kernel does
    not take; a tensor on the CPU takes :func:`frozen_norm_tail_reference`."""
    if (shortcut_scale is None) != (shortcut_bias is None):
        raise ValueError("give both of shortcut_scale and shortcut_bias, or "
                         "neither")
    if y.device.type == "cpu":
        return frozen_norm_tail_reference(y, scale, bias, shortcut,
                                          shortcut_scale, shortcut_bias)
    _launch(y, scale, bias, shortcut, shortcut_scale, shortcut_bias,
            "frozen_norm.tail")
    return y


def _aligned(name: str, t: torch.Tensor) -> int:
    if t.data_ptr() % 16:       # the kernel's 16-byte loads and stores
        raise ValueError(f"{name} must start on a 16-byte boundary")
    return t.data_ptr()


def _check_map(name: str, t: torch.Tensor, y: torch.Tensor) -> None:
    if t.shape != y.shape or t.dtype != y.dtype or t.device != y.device or \
            not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name} must be a channels_last map of y's shape "
                         f"{tuple(y.shape)} and dtype {y.dtype} on "
                         f"{y.device}, got {t.dtype} {tuple(t.shape)} "
                         f"{tuple(t.stride())} on {t.device}")


def _channels(name: str, t: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if t.dtype != y.dtype:
        t = t.to(y.dtype)
    if t.shape != y.shape[1:2] or t.device != y.device or \
            not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous ({y.shape[1]},) on "
                         f"{y.device}, got {tuple(t.shape)} on {t.device}")
    return t


def _launch(y, scale, bias, shortcut, shortcut_scale, shortcut_bias,
            count: str) -> None:
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    if y.dtype not in DTYPES or y.dim() != 4 or \
            not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"y must be a bfloat16 or float32 (N, C, H, W) map "
                         f"in channels_last memory, got {y.dtype} "
                         f"{tuple(y.shape)} {tuple(y.stride())}")
    vector = 16 // y.element_size()
    if y.shape[1] % vector:
        raise ValueError(f"the channel count must be a multiple of {vector} "
                         f"in {y.dtype}, got {y.shape[1]}")
    # held until the launch is queued: a cast's copy lives in these names
    scale, bias = _channels("scale", scale, y), _channels("bias", bias, y)
    ptrs = [None, None, None]
    if shortcut is not None:
        _check_map("shortcut", shortcut, y)
        ptrs[0] = _aligned("shortcut", shortcut)
        if shortcut_scale is not None:
            shortcut_scale = _channels("shortcut_scale", shortcut_scale, y)
            shortcut_bias = _channels("shortcut_bias", shortcut_bias, y)
            ptrs[1:] = (_aligned("shortcut_scale", shortcut_scale),
                        _aligned("shortcut_bias", shortcut_bias))
    launch(LIBRARY, "td_frozen_norm", y.device, _aligned("y", y),
           y.data_ptr(), _aligned("scale", scale), _aligned("bias", bias),
           *ptrs, y.numel(), y.shape[1], int(y.dtype == torch.bfloat16),
           count=count)
