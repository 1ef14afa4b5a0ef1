"""Attention with decomposed relative positions (ViTDet): the CUDA kernel,
its wrapper and its plain version.

Replaces no TPU kernel: the JAX package has no transformer backbone.  The
ViT-L backbone of Mask R-CNN ViTDet (``models/vit.py``) attends in every
block either within windows of the token map or over the whole map, and
adds detectron2's decomposed relative-position bias to every logit:

    logit(q, k) = scale * q.k + q.Rh[qh - kh + Sh - 1] + q.Rw[qw - kw + Sw - 1]

(q unscaled in the two bias terms; (qh, qw) and (kh, kw) the tokens'
coordinates in their window of Sh x Sw).  :func:`relpos_attention` takes
the qkv projection's output over the unpadded (B, H, W) map, channels in
detectron2's (3, heads, 64) order, and returns the attention's output in
(B, H, W, heads * 64), the output projection's input.  With a window, the
map is padded up to a multiple of it as detectron2 pads the normed map with
zeros: a pad token's q, k and v are the qkv bias, and the pad keys take
part in the softmax (they are not masked).

``csrc/relpos_attention.cu`` (``LIBRARY``, built, bound and launched by
``treedetection_tpu_torch.build``) does a whole block of a batch in one
launch: it reads q, k and v by TMA in window-shaped boxes of the
projection's output (the descriptors encoded on the host from the pointers
and shapes, nothing read back) and the bias for the pad keys, and writes the
output in place of the unpartitioned map, so no window is partitioned,
padded or permuted in memory.  Its source says what bounds it and how its design answers.  For a
CUDA tensor the wrapper launches it or raises (bfloat16 only, head size 64,
16-byte aligned inputs); only a tensor on the CPU takes
:func:`relpos_attention_reference`, the attention materialised in float32 as
detectron2's ``add_decomposed_rel_pos`` computes it.
"""

from __future__ import annotations

import ctypes

import torch

from treedetection_tpu_torch.build import cuda_library, launch

HEAD_DIM = 64
MAX_SIDE = 64

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = cuda_library("relpos_attention", {
    "td_relpos_attention": [_P] * 4 + [_L, _L, _P] + [_I] * 6
    + [ctypes.c_float, _P]})


def _check(qkv, bias, rel_h, rel_w, num_heads, window):
    if qkv.dim() != 4 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, H, W, 3C), got {tuple(qkv.shape)}")
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    if num_heads < 1 or c % num_heads:
        raise ValueError(f"{c} channels in {num_heads} heads")
    d = c // num_heads
    if tuple(bias.shape) != (c3,):
        raise ValueError(f"bias must be ({c3},), got {tuple(bias.shape)}")
    # square windows, or the whole map (global attention)
    sh, sw = (window, window) if window else (h, w)
    for name, t, side in (("rel_h", rel_h, sh), ("rel_w", rel_w, sw)):
        want = (2 * side - 1, d)
        if tuple(t.shape[-2:]) != want or t.dim() not in (2, 3) or (
                t.dim() == 3 and t.shape[0] != num_heads):
            raise ValueError(f"{name} must be {want} or ({num_heads},) + "
                             f"{want}, got {tuple(t.shape)}")
    for name, t in (("bias", bias), ("rel_h", rel_h), ("rel_w", rel_w)):
        if t.device != qkv.device:
            raise ValueError(f"{name} is on {t.device}, qkv on {qkv.device}")
    return b, h, w, c, d, sh, sw


def relpos_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     rel_h: torch.Tensor, rel_w: torch.Tensor,
                     num_heads: int, window: int) -> torch.Tensor:
    """Multi-head attention of a ViTDet block with the decomposed
    relative-position bias.

    ``qkv`` (B, H, W, 3C): the qkv projection of the normed (B, H, W)
    token map, channels (3, heads, C / heads); ``bias`` (3C,): the
    projection's bias, the q, k and v of a pad token; ``rel_h`` (2Sh - 1, D)
    and ``rel_w`` (2Sw - 1, D), shared by the heads, or one per head
    (heads, 2S - 1, D); ``window``: the side of the square windows, or 0 for
    global attention over the whole map.  Returns (B, H, W, C) in ``qkv``'s
    dtype: each head's output, heads concatenated, before the projection.

    On the card: one launch of the kernel for the whole call (bfloat16
    contiguous inputs, head size 64, window sides up to 64), counted on
    ``relpos.window`` or ``relpos.global``.  Raises for what the kernel
    does not take; a tensor on the CPU takes
    :func:`relpos_attention_reference`."""
    b, h, w, c, d, sh, sw = _check(qkv, bias, rel_h, rel_w, num_heads,
                                   window)
    if qkv.device.type == "cpu":
        return relpos_attention_reference(qkv, bias, rel_h, rel_w, num_heads,
                                          window)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    if d != HEAD_DIM or max(sh, sw) > MAX_SIDE:
        raise ValueError(f"the kernel takes head size {HEAD_DIM} and window "
                         f"sides up to {MAX_SIDE}, got {d} and {(sh, sw)}")
    for name, t in (("qkv", qkv), ("bias", bias), ("rel_h", rel_h),
                    ("rel_w", rel_w)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous bfloat16, got "
                             f"{t.dtype} {tuple(t.stride())}")
        if t.data_ptr() % 16:   # TMA and the pad rows' 16-byte loads
            raise ValueError(f"{name} must start on a 16-byte boundary")
    out = torch.empty((b, h, w, c), dtype=qkv.dtype, device=qkv.device)
    table_stride = [t.stride(0) if t.dim() == 3 else 0
                    for t in (rel_h, rel_w)]
    launch(LIBRARY, "td_relpos_attention", qkv.device, qkv.data_ptr(),
           bias.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(), *table_stride,
           out.data_ptr(), b, h, w, num_heads, sh, sw, d ** -0.5,
           count="relpos.window" if window else "relpos.global")
    return out


def rel_index(side: int, device=None) -> torch.Tensor:
    """(side, side) rows of a (2 side - 1)-row table: q - k + side - 1
    (detectron2's ``get_rel_pos`` where the table has its full length)."""
    r = torch.arange(side, device=device)
    return r[:, None] - r[None, :] + side - 1


def relpos_attention_reference(qkv: torch.Tensor, bias: torch.Tensor,
                               rel_h: torch.Tensor, rel_w: torch.Tensor,
                               num_heads: int, window: int) -> torch.Tensor:
    """The plain version of :func:`relpos_attention`, in float32: the map
    padded with the bias up to a multiple of the window, partitioned, and
    every window's logits materialised with the bias added as detectron2's
    ``add_decomposed_rel_pos`` adds it.  Returns ``qkv``'s dtype."""
    b, h, w, c, d, sh, sw = _check(qkv, bias, rel_h, rel_w, num_heads,
                                   window)
    x = qkv.float()
    hp, wp = -(-h // sh) * sh, -(-w // sw) * sw
    if (hp, wp) != (h, w):
        padded = bias.float().expand(b, hp, wp, 3 * c).clone()
        padded[:, :h, :w] = x
        x = padded
    nh, nw = hp // sh, wp // sw
    # (3, windows, heads, Sh, Sw, D)
    x = x.reshape(b, nh, sh, nw, sw, 3, num_heads, d).permute(
        5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b * nh * nw, num_heads, sh, sw, d)
    q, k, v = x[0], x[1], x[2]
    n = sh * sw
    rh = rel_h.float()
    rw = rel_w.float()
    rh = (rh[:, rel_index(sh, rh.device)] if rh.dim() == 3
          else rh[rel_index(sh, rh.device)][None])   # (heads|1, Sh, Sh, D)
    rw = (rw[:, rel_index(sw, rw.device)] if rw.dim() == 3
          else rw[rel_index(sw, rw.device)][None])
    attn = (q.reshape(-1, num_heads, n, d) * d ** -0.5) @ \
        k.reshape(-1, num_heads, n, d).transpose(-1, -2)
    bias_h = torch.einsum("whyxd,hykd->whyxk", q, rh.expand(
        num_heads, sh, sh, d))
    bias_w = torch.einsum("whyxd,hxkd->whyxk", q, rw.expand(
        num_heads, sw, sw, d))
    attn = (attn.reshape(-1, num_heads, sh, sw, sh, sw)
            + bias_h[..., :, None] + bias_w[..., None, :])
    attn = torch.softmax(attn.reshape(-1, num_heads, n, n), dim=-1)
    out = attn @ v.reshape(-1, num_heads, n, d)     # (windows, heads, n, D)
    out = out.reshape(b, nh, nw, num_heads, sh, sw, d).permute(
        0, 1, 4, 2, 5, 3, 6).reshape(b, hp, wp, c)
    return out[:, :h, :w].to(qkv.dtype)
