"""Attention with decomposed relative positions (ViTDet, MViTv2): the CUDA
kernels, their wrappers and their plain versions.

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

The MViTv2 backbone of Mask R-CNN MViTv2 (``models/mvit.py``) pools q, k and
v each by its own strided conv before it attends, so that the query and key
maps (and windows) differ in size; the bias rows then follow detectron2's
``get_rel_pos`` with the coordinates scaled by the sides' ratio
(:func:`pooled_rel_index`), from tables at ``2 max(q, k) - 1`` rows
(:func:`resize_table` resizes a stored table linearly), and the pooled q is
added to the output (residual pooling).  :func:`pooled_attention` takes the
pooled and normed q and k, v maps as they are, head-major images, and
returns (B, Hq, Wq, heads * 96); the same library's pooled form does a
whole block of a batch in one launch, reading the maps in place, and
:func:`pooled_attention_reference` materialises it in float32 as detectron2
computes it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from treedetection_tpu_torch.build import cuda_library, launch

HEAD_DIM = 64
MAX_SIDE = 64

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = cuda_library("relpos_attention", {
    "td_relpos_attention": [_P] * 4 + [_L, _L, _P] + [_I] * 6
    + [ctypes.c_float, _P],
    "td_relpos_attention_pooled": [_P] * 6 + [_I] * 12
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


# -- pooling attention (MViTv2) ----------------------------------------------

POOLED_HEAD_DIM = 96
POOLED_MAX_KV_SIDE = 32
POOLED_MAX_Q_SIDE = 128


def table_rows(q_side: int, k_side: int) -> int:
    """Rows of the table that an axis with query side ``q_side`` and key
    side ``k_side`` reads: 2 max(q, k) - 1 (detectron2's ``get_rel_pos``)."""
    return 2 * max(q_side, k_side) - 1


def resize_table(table: torch.Tensor, rows: int) -> torch.Tensor:
    """A (L, D) relative-position table at ``rows`` rows, in float32: as
    stored where L is ``rows``, else resized by linear interpolation with
    ``align_corners=False``, as detectron2's ``get_rel_pos`` resizes it."""
    t = table.float()
    if t.shape[0] == rows:
        return t
    return F.interpolate(t.T[None], size=rows, mode="linear",
                         align_corners=False)[0].T


def pooled_rel_index(q_side: int, k_side: int, device=None) -> torch.Tensor:
    """(q_side, k_side) table rows of detectron2's ``get_rel_pos`` where the
    two sides differ: ``q max(k/q, 1) - k max(q/k, 1) + (k_side - 1)
    max(q/k, 1)``, in float32 and truncated, as detectron2 computes it."""
    qs = torch.arange(q_side, device=device)[:, None] * max(
        k_side / q_side, 1.0)
    ks = torch.arange(k_side, device=device)[None, :] * max(
        q_side / k_side, 1.0)
    return ((qs - ks) + (k_side - 1) * max(q_side / k_side, 1.0)).long()


def _check_pooled(q, k, v, rel_h, rel_w, num_heads, q_window, kv_window):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B * heads, H, W, D), got "
                             f"{tuple(t.shape)}")
    n, hq, wq, d = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != n or \
            k.shape[-1] != d:
        raise ValueError(f"k and v must be (B * heads, Hk, Wk, {d}) beside "
                         f"q {tuple(q.shape)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if num_heads < 1 or n % num_heads:
        raise ValueError(f"{n} maps are not images of {num_heads} heads")
    hk, wk = k.shape[1:3]
    if bool(q_window) != bool(kv_window):
        raise ValueError("q and kv are windowed together or not at all")
    (sqh, sqw), (skh, skw) = (((q_window,) * 2, (kv_window,) * 2)
                              if q_window else ((hq, wq), (hk, wk)))
    if -(-hq // sqh) != -(-hk // skh) or -(-wq // sqw) != -(-wk // skw):
        raise ValueError(f"the q map {(hq, wq)} in windows of {(sqh, sqw)} "
                         f"and the kv map {(hk, wk)} in windows of "
                         f"{(skh, skw)} give different window grids")
    for name, t, rows in (("rel_h", rel_h, table_rows(sqh, skh)),
                          ("rel_w", rel_w, table_rows(sqw, skw))):
        if tuple(t.shape) != (rows, d):
            raise ValueError(f"{name} must be ({rows}, {d}), got "
                             f"{tuple(t.shape)}")
    for name, t in (("k", k), ("v", v), ("rel_h", rel_h), ("rel_w", rel_w)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    return n, hq, wq, hk, wk, d, (sqh, sqw), (skh, skw)


def pooled_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     rel_h: torch.Tensor, rel_w: torch.Tensor,
                     num_heads: int, q_window: int,
                     kv_window: int) -> torch.Tensor:
    """Pooling attention of an MViTv2 block with the decomposed
    relative-position bias and the residual pooled q.

    ``q`` (B * heads, Hq, Wq, D) and ``k``, ``v`` (B * heads, Hk, Wk, D):
    the pooled and normed maps, image-major; ``rel_h`` and ``rel_w`` (L, D):
    each axis's table at the rows it reads (:func:`table_rows` of its query
    and key sides, resized by :func:`resize_table` where stored otherwise);
    ``q_window`` and ``kv_window``: the sides of the square query and key
    windows, or both 0 for global attention over the maps.  The maps are
    zero-padded to their windows (after the norm, so a pad key's k and v
    are 0, and it takes part in the softmax).  Returns (B, Hq, Wq, heads *
    D) in ``q``'s dtype: each head's attention plus its q, heads
    concatenated, the output projection's input.

    On the card: one launch of ``relpos_attention_kernel_pooled`` for the
    whole call (bfloat16 contiguous inputs, head size 96, key sides up to
    32 and query sides up to 128, the larger of an axis's two sides a
    multiple of the smaller),
    counted on ``relpos.pooled_window`` or ``relpos.pooled_global``.
    Raises for what the kernel does not take; a tensor on the CPU takes
    :func:`pooled_attention_reference`."""
    n, hq, wq, hk, wk, d, (sqh, sqw), (skh, skw) = _check_pooled(
        q, k, v, rel_h, rel_w, num_heads, q_window, kv_window)
    if q.device.type == "cpu":
        return pooled_attention_reference(q, k, v, rel_h, rel_w, num_heads,
                                          q_window, kv_window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if d != POOLED_HEAD_DIM or max(skh, skw) > POOLED_MAX_KV_SIDE or \
            max(sqh, sqw) > POOLED_MAX_Q_SIDE:
        raise ValueError(f"the kernel takes head size {POOLED_HEAD_DIM}, key "
                         f"sides up to {POOLED_MAX_KV_SIDE} and query sides "
                         f"up to {POOLED_MAX_Q_SIDE}, got {d}, {(skh, skw)} "
                         f"and {(sqh, sqw)}")
    for qs, ks in ((sqh, skh), (sqw, skw)):
        if max(qs, ks) % min(qs, ks):
            raise ValueError(f"the kernel takes sides of which the larger "
                             f"is a multiple of the smaller, got {qs} and "
                             f"{ks}")
    for name, t in (("q", q), ("k", k), ("v", v), ("rel_h", rel_h),
                    ("rel_w", rel_w)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous bfloat16, got "
                             f"{t.dtype} {tuple(t.stride())}")
        if t.data_ptr() % 16:   # 16-byte copies
            raise ValueError(f"{name} must start on a 16-byte boundary")
    out = torch.empty((n // num_heads, hq, wq, num_heads * d),
                      dtype=q.dtype, device=q.device)
    launch(LIBRARY, "td_relpos_attention_pooled", q.device, q.data_ptr(),
           k.data_ptr(), v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
           out.data_ptr(), n, num_heads, hq, wq, hk, wk, sqh, sqw, skh, skw,
           rel_h.shape[0], rel_w.shape[0], d ** -0.5,
           count="relpos.pooled_window" if q_window
           else "relpos.pooled_global")
    return out


def _partition(x: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    """(N, H, W, D) zero-padded to multiples of (sh, sw) -> (N * windows,
    sh * sw, D), windows row-major (detectron2's ``window_partition``)."""
    n, h, w, d = x.shape
    hp, wp = -(-h // sh) * sh, -(-w // sw) * sw
    x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
    return x.reshape(n, hp // sh, sh, wp // sw, sw, d).permute(
        0, 1, 3, 2, 4, 5).reshape(-1, sh * sw, d)


def pooled_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, rel_h: torch.Tensor,
                               rel_w: torch.Tensor, num_heads: int,
                               q_window: int,
                               kv_window: int) -> torch.Tensor:
    """The plain version of :func:`pooled_attention`, in float32: the maps
    zero-padded and partitioned, every window's logits materialised with
    the bias added as detectron2's ``add_decomposed_rel_pos`` adds it
    (rows from :func:`pooled_rel_index`), the softmax over every key of the
    window, the windows put back, the pads dropped and q added.  Returns
    ``q``'s dtype."""
    n, hq, wq, hk, wk, d, (sqh, sqw), (skh, skw) = _check_pooled(
        q, k, v, rel_h, rel_w, num_heads, q_window, kv_window)
    qf = q.float()
    qw = _partition(qf, sqh, sqw)
    kw = _partition(k.float(), skh, skw)
    vw = _partition(v.float(), skh, skw)
    rh = rel_h.float()[pooled_rel_index(sqh, skh, q.device)]
    rw = rel_w.float()[pooled_rel_index(sqw, skw, q.device)]
    attn = (qw * d ** -0.5) @ kw.transpose(-1, -2)
    rq = qw.reshape(-1, sqh, sqw, d)
    bias_h = torch.einsum("nhwc,hkc->nhwk", rq, rh)
    bias_w = torch.einsum("nhwc,wkc->nhwk", rq, rw)
    attn = (attn.reshape(-1, sqh, sqw, skh, skw) + bias_h[..., :, None]
            + bias_w[..., None, :]).reshape(-1, sqh * sqw, skh * skw)
    out = torch.softmax(attn, dim=-1) @ vw
    nh, nw = -(-hq // sqh), -(-wq // sqw)
    out = out.reshape(n, nh, nw, sqh, sqw, d).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(n, nh * sqh, nw * sqw, d)[:, :hq, :wq] + qf
    out = out.reshape(n // num_heads, num_heads, hq, wq, d).permute(
        0, 2, 3, 1, 4).reshape(n // num_heads, hq, wq, num_heads * d)
    return out.to(q.dtype)
