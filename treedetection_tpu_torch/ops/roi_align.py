"""Multilevel ROIAlign (aligned / "V2" semantics), whole-batch flat path.

Counterpart of the default path of ``treedetection_tpu/ops/roi_align.py``
(``multilevel_roi_align_batched`` with ``TD_ROI_FLAT=1`` and the small patch
class off): every box pools from its FPN level through one launch of the
flat patch pooler (K1, ``ops/kernels/roi_align.py``), and a per-image budget
of boxes that outspan the 48-row patch is re-pooled exactly through the
gather tail.  The port reads none of the ``TD_ROI_*`` environment variables.

Semantics: aligned=True coordinates (half-pixel shift), a fixed 2x2 sampling
grid per bin, detectron2 FPN level assignment, zero contribution from samples
outside (-1, H).
"""

from __future__ import annotations

import logging
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from treedetection_tpu_torch.config import LOGGER_NAME
from treedetection_tpu_torch.ops.kernels.roi_align import roi_pool_patches_flat
from treedetection_tpu_torch.ops.nms import stable_topk

# Static per-box patch span (rows); the column window is PATCH + 8 because the
# column origin snaps down to a multiple of 8.
PATCH = 48
CPATCH = PATCH + 8

# Per-image budgets of boxes re-pooled through the exact gather tail (box
# pool R <= 8, mask pool otherwise); boxes beyond them keep truncated pooling
# and are flagged in the returned inexact mask.
EXACT_FRAC_BOX = 0.05
EXACT_FRAC_MASK = 0.08

_logger = logging.getLogger(LOGGER_NAME)

# Host-visible tally of truncated poolings (see report_overflow_host).
OVERFLOW_STATS = {"events": 0, "boxes_beyond_budget": 0}


def report_overflow_host(n_over: int, context: str = "",
                         budget: int = 0) -> None:
    """Warn + tally when a fetched truncation count (``ModelOutput.
    roi_overflow`` / ``prop_overflow``) is positive: those boxes outspanned
    the patch beyond every exact re-pooling budget."""
    n_over = int(n_over)
    if n_over <= budget:
        return
    OVERFLOW_STATS["events"] += 1
    OVERFLOW_STATS["boxes_beyond_budget"] += n_over - budget
    _logger.warning(
        f"ROIAlign patch overflow{context}: {n_over - budget} boxes exceeded "
        f"the exact re-pooling budget and keep truncated pooling (bounded "
        f"error on the overhanging bins)")


def exact_budget(n_per_image: int, resolution: int) -> int:
    """Per-image size of the exact gather tail."""
    frac = EXACT_FRAC_BOX if resolution <= 8 else EXACT_FRAC_MASK
    return min(n_per_image, int(np.ceil(n_per_image * frac)))


def assign_fpn_levels(boxes: torch.Tensor, min_level: int = 2,
                      max_level: int = 5, canonical_size: float = 224.0,
                      canonical_level: int = 4) -> torch.Tensor:
    """FPN level per box (0-based from ``min_level``): floor(L0 +
    log2(sqrt(area)/224)), clamped — detectron2 ``assign_boxes_to_levels``."""
    area = (torch.clamp(boxes[:, 2] - boxes[:, 0], min=0)
            * torch.clamp(boxes[:, 3] - boxes[:, 1], min=0))
    size = torch.sqrt(area)
    lvl = torch.floor(canonical_level + torch.log2(size / canonical_size + 1e-8))
    return torch.clamp(lvl, min_level, max_level).to(torch.int64) - min_level


def _sample_grid(boxes: torch.Tensor, spatial_scale: torch.Tensor,
                 resolution: int, sampling_ratio: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Continuous sampling coordinates, (N, R, R, S, S) each, in feature-map
    coordinates; ``spatial_scale`` is per box (N,)."""
    n = boxes.shape[0]
    sboxes = boxes * spatial_scale[:, None]
    x0 = sboxes[:, 0] - 0.5
    y0 = sboxes[:, 1] - 0.5
    bin_w = (sboxes[:, 2] - sboxes[:, 0]) / resolution
    bin_h = (sboxes[:, 3] - sboxes[:, 1]) / resolution
    r = torch.arange(resolution, dtype=boxes.dtype, device=boxes.device)
    s = (torch.arange(sampling_ratio, dtype=boxes.dtype, device=boxes.device)
         + 0.5) / sampling_ratio
    off = r[:, None] + s[None, :]                                  # (R, S)
    ys = y0[:, None, None] + off[None] * bin_h[:, None, None]      # (N, R, S)
    xs = x0[:, None, None] + off[None] * bin_w[:, None, None]
    shape = (n, resolution, resolution, sampling_ratio, sampling_ratio)
    ys = ys[:, :, None, :, None].expand(shape)
    xs = xs[:, None, :, None, :].expand(shape)
    return ys, xs


def _patch_pool_prep(flat_boxes: torch.Tensor, hs: np.ndarray, ws: np.ndarray,
                     strides: Sequence[int], resolution: int,
                     sampling_ratio: int, n_levels: int):
    """Per-box patch geometry: FPN level, clamped patch origin, and
    patch-relative sample coords with ROIAlign edge semantics.

    -> (levels, oy, ox, sy, sx, valid_y, valid_x)
    """
    dev, dt = flat_boxes.device, flat_boxes.dtype
    levels = assign_fpn_levels(flat_boxes, min_level=2, max_level=1 + n_levels)
    scale = (1.0 / torch.tensor(strides, dtype=dt, device=dev))[levels]
    h_l = torch.as_tensor(hs, device=dev)[levels]
    w_l = torch.as_tensor(ws, device=dev)[levels]

    sboxes = flat_boxes * scale[:, None]
    x0 = sboxes[:, 0] - 0.5
    y0 = sboxes[:, 1] - 0.5
    bin_w = (sboxes[:, 2] - sboxes[:, 0]) / resolution
    bin_h = (sboxes[:, 3] - sboxes[:, 1]) / resolution
    oy = torch.minimum(torch.clamp(torch.floor(y0).to(torch.int64), min=0),
                       torch.clamp(h_l - 1, min=0))
    ox = torch.minimum(torch.clamp(torch.floor(x0).to(torch.int64), min=0),
                       torch.clamp(w_l - 1, min=0))

    s = (torch.arange(sampling_ratio, dtype=dt, device=dev) + 0.5) \
        / sampling_ratio
    offs = (torch.arange(resolution, dtype=dt, device=dev)[:, None]
            + s[None, :]).reshape(-1)                              # (R*S,)
    sy_abs = y0[:, None] + offs[None, :] * bin_h[:, None]
    sx_abs = x0[:, None] + offs[None, :] * bin_w[:, None]
    hf = h_l.to(dt)[:, None]
    wf = w_l.to(dt)[:, None]
    valid_y = (sy_abs > -1.0) & (sy_abs < hf)
    valid_x = (sx_abs > -1.0) & (sx_abs < wf)
    sy = torch.minimum(torch.clamp(sy_abs, min=0.0), hf - 1.0) - oy.to(dt)[:, None]
    sx = torch.minimum(torch.clamp(sx_abs, min=0.0), wf - 1.0) - ox.to(dt)[:, None]
    return levels, oy, ox, sy, sx, valid_y, valid_x


def _hat_matrix(samples: torch.Tensor, size: int) -> torch.Tensor:
    """(..., S) fractional sample coords -> (..., S, size) bilinear weights
    ``relu(1 - |s - k|)`` (the "hat" kernel; zero outside the array)."""
    rows = torch.arange(size, dtype=samples.dtype, device=samples.device)
    return torch.clamp(1.0 - torch.abs(samples[..., None] - rows), min=0.0)


def _fold_hats(sy: torch.Tensor, sx: torch.Tensor, valid_y: torch.Tensor,
               valid_x: torch.Tensor, resolution: int, sampling_ratio: int,
               width_x: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold the S-sample bin average into (N, R, PATCH) / (N, R, width_x)
    hat matrices."""
    n = sy.shape[0]
    ay = (_hat_matrix(sy, PATCH) * valid_y[..., None]).reshape(
        n, resolution, sampling_ratio, PATCH).mean(dim=2)
    ax = (_hat_matrix(sx, width_x) * valid_x[..., None]).reshape(
        n, resolution, sampling_ratio, width_x).mean(dim=2)
    return ay, ax


def _gather_rows_core(flat: torch.Tensor, bases: np.ndarray, wps: np.ndarray,
                      hs: np.ndarray, ws: np.ndarray, boxes: torch.Tensor,
                      levels: torch.Tensor, img: torch.Tensor,
                      resolution: int, strides: Sequence[int],
                      sampling_ratio: int) -> torch.Tensor:
    """Exact gather ROIAlign of M (box, level, image) triples against the
    flattened (rows*cols, C) buffer -> (M, R, R, C) float32.

    ``bases``: (L,) flat-element base of level l's section; ``wps``: (L,)
    row pitch in elements.
    """
    dev, dt = boxes.device, boxes.dtype
    c = flat.shape[-1]
    hps = np.asarray(hs) + PATCH

    def per_box(values):
        return torch.as_tensor(np.asarray(values), device=dev)[levels][
            :, None, None, None, None]

    scales = 1.0 / torch.tensor(strides, dtype=dt, device=dev)
    ys, xs = _sample_grid(boxes, scales[levels], resolution, sampling_ratio)
    h, w, hp, wp = per_box(hs), per_box(ws), per_box(hps), per_box(wps)
    base = per_box(bases) + (img[:, None, None, None, None] * hp) * wp
    hf = h.to(dt)
    wf = w.to(dt)
    valid = (ys > -1.0) & (ys < hf) & (xs > -1.0) & (xs < wf)
    y = torch.minimum(torch.clamp(ys, min=0.0), hf - 1.0)
    x = torch.minimum(torch.clamp(xs, min=0.0), wf - 1.0)
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    y1 = torch.minimum(y0 + 1, h - 1)
    x1 = torch.minimum(x0 + 1, w - 1)
    ly = (y - y0.to(dt))[..., None]
    lx = (x - x0.to(dt))[..., None]

    def rows(yy, xx):
        idx = (base + yy * wp + xx).reshape(-1)
        return flat[idx].reshape(*yy.shape, c).to(dt)

    out = (rows(y0, x0) * (1 - ly) * (1 - lx)
           + rows(y0, x1) * (1 - ly) * lx
           + rows(y1, x0) * ly * (1 - lx)
           + rows(y1, x1) * ly * lx)
    out = torch.where(valid[..., None], out, torch.zeros((), dtype=dt, device=dev))
    return out.mean(dim=(3, 4))


PoolFn = Callable[..., torch.Tensor]


class FlatPoolInputs(NamedTuple):
    """Everything a flat pooling call needs, from one batch of boxes."""
    kcat: torch.Tensor        # (sum_l B*(H_l+PATCH), W_max+CPATCH, C)
    rows: torch.Tensor        # (B*N,) int32 absolute window row
    cols: torch.Tensor        # (B*N,) int32 window column, multiple of 8
    ay: torch.Tensor          # (B*N, R, PATCH) float32
    ax: torch.Tensor          # (B*N, R, CPATCH) float32
    overflow: torch.Tensor    # (B*N,) bool — samples outspan the window
    levels: torch.Tensor      # (B*N,) int64 FPN level (0-based)
    img: torch.Tensor         # (B*N,) int64 image index
    flat_boxes: torch.Tensor  # (B*N, 4)
    hs: np.ndarray            # (L,) level heights
    ws: np.ndarray            # (L,) level widths
    lvl_base: np.ndarray      # (L,) first kcat row of each level's sections


def flat_pool_inputs(fmaps: Sequence[torch.Tensor], boxes: torch.Tensor,
                     resolution: int, strides: Sequence[int],
                     sampling_ratio: int = 2) -> FlatPoolInputs:
    """Build the level-concatenated buffer and every box's window origin
    and hat matrices (see :func:`multilevel_roi_align_batched`)."""
    b, n = boxes.shape[0], boxes.shape[1]
    c = fmaps[0].shape[-1]
    dev = boxes.device
    flat_boxes = boxes.reshape(b * n, 4)
    img = torch.arange(b, device=dev).repeat_interleave(n)
    hs = np.asarray([f.shape[1] for f in fmaps])
    ws = np.asarray([f.shape[2] for f in fmaps])

    # ONE uniform-width buffer for every (level, image) section: image b of
    # level l starts at row lvl_base[l] + b * (H_l + PATCH); the bottom and
    # right zero padding keeps every window inside its own section
    wmax = int(ws.max()) + CPATCH
    sec_rows = (hs + PATCH) * b
    lvl_base = np.concatenate([[0], np.cumsum(sec_rows)[:-1]])
    kcat = torch.zeros((int(sec_rows.sum()), wmax, c), dtype=fmaps[0].dtype,
                       device=dev)
    for l, f in enumerate(fmaps):
        h, w = int(hs[l]), int(ws[l])
        sec = kcat[int(lvl_base[l]):int(lvl_base[l] + sec_rows[l])]
        sec.view(b, h + PATCH, wmax, c)[:, :h, :w] = f

    levels, oy, ox, sy, sx, valid_y, valid_x = _patch_pool_prep(
        flat_boxes, hs, ws, strides, resolution, sampling_ratio, len(fmaps))
    ox_al = (ox // 8) * 8
    sx_al = sx + (ox - ox_al).to(flat_boxes.dtype)[:, None]
    ay, ax = _fold_hats(sy, sx_al, valid_y, valid_x, resolution,
                        sampling_ratio, CPATCH)
    overflow = ((sy.amax(dim=1) > PATCH - 1)
                | (sx_al.amax(dim=1) > CPATCH - 1))
    row_base = img * torch.as_tensor(hs + PATCH, device=dev)[levels]
    abs_row = torch.as_tensor(lvl_base, device=dev)[levels] + row_base + oy
    return FlatPoolInputs(
        kcat=kcat, rows=abs_row.to(torch.int32).contiguous(),
        cols=ox_al.to(torch.int32).contiguous(), ay=ay.contiguous(),
        ax=ax.contiguous(), overflow=overflow, levels=levels, img=img,
        flat_boxes=flat_boxes, hs=hs, ws=ws, lvl_base=lvl_base)


def multilevel_roi_align_batched(fmaps: Sequence[torch.Tensor],
                                 boxes: torch.Tensor, resolution: int,
                                 strides: Sequence[int],
                                 sampling_ratio: int = 2,
                                 pool: Optional[PoolFn] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-batch multilevel ROIAlign: ``fmaps[l]`` (B, H_l, W_l, C) NHWC,
    ``boxes`` (B, N, 4) float32 -> ((B, N, R, R, C) in the feature dtype,
    (B, N) bool inexact mask).

    Every (level, image) section is row-concatenated into ONE zero-padded
    (sum_l B*(H_l+PATCH), W_max+CPATCH, C) buffer, so a box's window origin
    is a single absolute row and an 8-aligned column, and one launch of
    ``pool`` (default: the K1 kernel wrapper; pass
    ``roi_pool_patches_flat_reference`` for the plain version) pools every
    box.  Boxes whose samples outspan the window are re-pooled exactly
    through the gather tail, highest-scoring first (proposals arrive
    score-descending, and the stable top-k breaks ties toward lower index),
    up to the per-image budget; the rest stay truncated and are flagged.
    Geometries whose boxes could outspan the patch on every level pool every
    box through the gather path.
    """
    pool = roi_pool_patches_flat if pool is None else pool
    b, n = boxes.shape[0], boxes.shape[1]
    c = fmaps[0].shape[-1]
    p = flat_pool_inputs(fmaps, boxes, resolution, strides, sampling_ratio)
    wmax = p.kcat.shape[1]

    def gather(sel):
        return _gather_rows_core(
            p.kcat.reshape(-1, c), p.lvl_base * wmax,
            np.full(len(fmaps), wmax), p.hs, p.ws, p.flat_boxes[sel],
            p.levels[sel], p.img[sel], resolution, strides, sampling_ratio)

    img_span = max(int(h) * s for h, s in zip(p.hs, strides))
    if img_span / strides[-1] > PATCH - 2:
        out = gather(slice(None)).to(p.kcat.dtype)
        return (out.reshape(b, n, resolution, resolution, c),
                torch.zeros((b, n), dtype=torch.bool, device=boxes.device))

    out = pool(p.kcat, p.rows, p.cols, p.ay, p.ax, resolution, PATCH)

    sel_exact = torch.zeros(b * n, dtype=torch.bool, device=boxes.device)
    m_exact = exact_budget(n, resolution)
    if m_exact > 0:
        flag, idx = stable_topk(
            p.overflow.reshape(b, n).to(torch.float32) * 2.0, m_exact)
        flat_e = (torch.arange(b, device=boxes.device)[:, None] * n
                  + idx).reshape(-1)
        take = (flag > 0).reshape(-1)
        fb = gather(flat_e)
        out[flat_e] = torch.where(take[:, None, None, None], fb.to(out.dtype),
                                  out[flat_e])
        sel_exact[flat_e] = take

    inexact = p.overflow & ~sel_exact
    return (out.reshape(b, n, resolution, resolution, c),
            inexact.reshape(b, n))
