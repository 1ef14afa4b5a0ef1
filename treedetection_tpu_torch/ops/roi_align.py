"""Multilevel ROIAlign (aligned / "V2" semantics): the whole-batch pooler in
its three layouts, the single-image pooler and the gather oracle.

Counterpart of ``treedetection_tpu/ops/roi_align.py``.  Every box pools from
its FPN level through a patch pooler (``ops/kernels/roi_align.py``), and a
per-image budget of boxes that outspan the 48-row patch is re-pooled exactly
through the gather tail.  ``multilevel_roi_align_batched`` picks the layout
of the feature buffers, and with it the kernel, from the environment at each
call, as the JAX function does:

* default (``TD_ROI_FLAT=1``, ``TD_ROI_RESIDENT=0``): one level-concatenated
  buffer padded to the widest level, pooled by K1 ``roi_pool_patches_flat``;
* ``TD_ROI_FLAT=0``: per-level buffers without the width padding, pooled by
  K5 ``roi_pool_patches``;
* ``TD_ROI_RESIDENT=1``: the per-level buffers pooled image by image and
  C-block by C-block by K6 ``roi_pool_resident`` (origins clamped into the
  unpadded sections, hats folded again).

``TD_ROI_SMALL`` (rows of a small patch class; default 0 = off),
``TD_ROI_LARGE_FRAC`` and ``TD_ROI_EXACT_FRAC`` steer the three-class scheme
(see ``_class_params``).  ``TD_ROI_CHUNK``, ``TD_ROI_SLOTS`` and
``TD_ROI_VMEM_MB`` steer the TPU kernels' DMA pipeline and VMEM budget and
have no counterpart here; ``TD_PALLAS_ROIALIGN`` and ``TD_PALLAS_INTERPRET``
neither (a wrapper takes its plain version for CPU tensors and its kernel
for CUDA tensors).

Training pools through ``multilevel_roi_align(differentiable=True)``, the
JAX function's ``pallas=False`` branch in PyTorch operations that autograd
differentiates, and crops GT masks with the single-level ``roi_align``.

Semantics: aligned=True coordinates (half-pixel shift), a fixed 2x2 sampling
grid per bin, detectron2 FPN level assignment, zero contribution from samples
outside (-1, H).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from treedetection_tpu_torch.config import LOGGER_NAME
from treedetection_tpu_torch.ops.kernels.roi_align import (
    TABLE_COLUMNS, resident_l2_budget, resident_section_bytes, roi_exact_tail,
    roi_geometry, roi_pool_patches, roi_pool_patches_flat, roi_pool_resident)
from treedetection_tpu_torch.ops.nms import stable_topk
from treedetection_tpu_torch.utils.profiling import span

# Static per-box patch span (rows); the column window is PATCH + 8 because the
# column origin snaps down to a multiple of 8.
PATCH = 48
CPATCH = PATCH + 8

# Out-of-span boxes the single-image pooler re-pools through the gather path
# per call; the excess keeps truncated pooling and is counted.
FALLBACK_BUDGET = 16

# Three-class patch pooling of the batched pooler.  (1) With a small patch
# class on (``TD_ROI_SMALL`` rows, nonzero), EVERY box pools through a
# (small, small+8) window; (2) a per-image budget of ``ceil(LARGE_FRAC * N)``
# boxes that do not fit it pools again through the full 48-row patch; (3) a
# per-image budget of ``ceil(EXACT_FRAC * N)`` boxes pools through the exact
# gather tail, which serves any span: boxes that outspan the 48-row patch
# first, class-2 spillover after them.  Budgets are per image and go to the
# highest-scoring boxes first (proposals arrive score-descending, and the
# stable top-k breaks ties toward the lower index).  Boxes beyond every
# budget keep truncated pooling and are flagged in the returned inexact mask.
# Default: small class off, so every box pools through the 48-row patch and
# exactness does not depend on the span distribution of the proposals.
SMALL_PATCH_BOX = 0      # resolution <= 8 (7x7 box pool)
SMALL_PATCH_MASK = 0     # resolution > 8 (14x14 mask pool)
LARGE_FRAC_BOX = 0.50
LARGE_FRAC_MASK = 0.25
EXACT_FRAC_BOX = 0.05
EXACT_FRAC_MASK = 0.08

# Boxes one block of the resident pooler (K6) serves, (box pool, mask pool)
# by feature dtype; each image's boxes are padded to a multiple of it.  The
# two dtypes run different device functions, and each keeps the fastest
# chunk of its own sweep on an H100 at the example geometry (``chip_smoke.py``,
# kernel phase, the kernel's device time at chunks 1 to 32).  bfloat16
# (pool_box_bf16): the box pool is flat from 4 to 16 boxes per block and
# slowest at 1, the mask pool flat from 1 to 4 and slower from 8 on.
# float32 (pool_box): the time rises with the chunk from 1 on.
RESIDENT_CHUNKS = {torch.bfloat16: (16, 2), torch.float32: (1, 1)}

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


def _class_params(n_per_image: int, resolution: int) -> Tuple[int, int, int]:
    """(small_patch, large_budget, exact_budget) of a batched pooling call
    with ``n_per_image`` boxes per image; budgets are per image.  Read from
    ``TD_ROI_SMALL``, ``TD_ROI_LARGE_FRAC`` and ``TD_ROI_EXACT_FRAC`` at
    each call, with the module's constants as defaults."""
    box = resolution <= 8
    small = int(os.environ.get(
        "TD_ROI_SMALL", str(SMALL_PATCH_BOX if box else SMALL_PATCH_MASK)))
    if small >= PATCH:
        small = 0
    lfrac = float(os.environ.get(
        "TD_ROI_LARGE_FRAC", str(LARGE_FRAC_BOX if box else LARGE_FRAC_MASK)))
    efrac = float(os.environ.get(
        "TD_ROI_EXACT_FRAC", str(EXACT_FRAC_BOX if box else EXACT_FRAC_MASK)))

    def budget(frac):
        return 0 if frac <= 0 else min(n_per_image, int(np.ceil(
            n_per_image * frac)))

    m_large = budget(lfrac) if small > 0 else 0   # small=0: all boxes large
    return max(small, 0), m_large, budget(efrac)


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


def roi_align(fmap: torch.Tensor, boxes: torch.Tensor, resolution: int,
              spatial_scale: float, sampling_ratio: int = 2) -> torch.Tensor:
    """ROIAlign on one map -> (N, R, R, C): ``fmap`` (H, W, C) for every
    box, or (N, H, W, C) with map n for box n (the JAX function under
    ``vmap``).  Samples outside (-1, H) contribute 0; inside, the
    coordinates clamp to the edge pixels."""
    n = boxes.shape[0]
    per_box = fmap.dim() == 4
    h, w = fmap.shape[-3], fmap.shape[-2]
    scale = torch.full((n,), spatial_scale, dtype=boxes.dtype,
                       device=boxes.device)
    ys, xs = _sample_grid(boxes, scale, resolution, sampling_ratio)
    valid = (ys > -1.0) & (ys < h) & (xs > -1.0) & (xs < w)
    y = torch.clamp(ys, 0.0, h - 1.0)
    x = torch.clamp(xs, 0.0, w - 1.0)
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    ly = (y - y0.to(y.dtype))[..., None]
    lx = (x - x0.to(x.dtype))[..., None]
    box = torch.arange(n, device=boxes.device)[:, None, None, None, None]

    def at(yy, xx):
        return fmap[box, yy, xx] if per_box else fmap[yy, xx]

    out = (at(y0, x0) * (1 - ly) * (1 - lx) + at(y0, x1) * (1 - ly) * lx
           + at(y1, x0) * ly * (1 - lx) + at(y1, x1) * ly * lx)
    out = torch.where(valid[..., None], out, torch.zeros((), dtype=out.dtype,
                                                         device=out.device))
    return out.mean(dim=(3, 4))


def _h2d(make, values, **kwargs) -> torch.Tensor:
    """``make(values, **kwargs)``: ``torch.tensor`` or ``torch.as_tensor``
    of host values (the level geometry) on the device; on the card a copy
    from pageable memory, which waits for the stream."""
    with span("sync.pool_h2d"):
        return make(values, **kwargs)


class LevelTable(NamedTuple):
    """The per-level constants of one pooling geometry on the device: one
    row per FPN level, ``TABLE_COLUMNS`` in ``packed`` (what the kernels
    read), each column also a view of it."""
    packed: torch.Tensor      # (L, 9) int64
    h: torch.Tensor           # level height
    w: torch.Tensor           # level width
    hp: torch.Tensor          # h + PATCH: rows of one image's section
    lvl_base: torch.Tensor    # first kcat row of the level's sections (K1)
    flat_pitch: torch.Tensor  # kcat's width, max w + CPATCH (K1)
    level_pitch: torch.Tensor  # w + CPATCH: the level buffer's width (K5, K6)
    stride: torch.Tensor
    max_r0: torch.Tensor      # K6's largest window row origin
    max_c0: torch.Tensor      # K6's largest window column origin
    hs: np.ndarray            # (L,) host copies of h and w
    ws: np.ndarray
    n_images: int


_TABLES: Dict[tuple, LevelTable] = {}
_TABLES_LOCK = threading.Lock()


def level_table(hs, ws, strides: Sequence[int], n_images: int,
                device) -> LevelTable:
    """The level table of levels ``hs`` x ``ws`` at ``strides`` for a batch
    of ``n_images`` on ``device``, copied to the device once per key and
    kept: the pooler then reads its level geometry with no copy from the
    host.  A device thread per device may ask at once."""
    hs = np.asarray(hs, dtype=np.int64)
    ws = np.asarray(ws, dtype=np.int64)
    strides = np.asarray(strides[:len(hs)], dtype=np.int64)
    device = torch.device(device)
    key = (tuple(hs.tolist()), tuple(ws.tolist()), tuple(strides.tolist()),
           int(n_images), device)
    table = _TABLES.get(key)
    if table is not None:
        return table
    with _TABLES_LOCK:
        table = _TABLES.get(key)
        if table is None:
            sec_rows = (hs + PATCH) * n_images
            columns = {
                "h": hs, "w": ws, "hp": hs + PATCH,
                "lvl_base": np.concatenate([[0], np.cumsum(sec_rows)[:-1]]),
                "flat_pitch": np.full_like(hs, ws.max() + CPATCH),
                "level_pitch": ws + CPATCH, "stride": strides,
                "max_r0": np.maximum(hs - PATCH, 0),
                "max_c0": np.maximum(ws - CPATCH, 0)}
            host = np.stack([columns[c] for c in TABLE_COLUMNS], axis=1)
            packed = _h2d(torch.as_tensor, host.astype(np.int64),
                          device=device)
            table = _TABLES[key] = LevelTable(
                packed, *packed.unbind(1), hs=hs, ws=ws,
                n_images=int(n_images))
    return table


def _patch_pool_prep(flat_boxes: torch.Tensor, table: LevelTable,
                     resolution: int, sampling_ratio: int):
    """Per-box patch geometry: FPN level, clamped patch origin, and
    patch-relative sample coords with ROIAlign edge semantics.

    -> (levels, oy, ox, sy, sx, valid_y, valid_x)
    """
    dev, dt = flat_boxes.device, flat_boxes.dtype
    levels = assign_fpn_levels(flat_boxes, min_level=2,
                               max_level=1 + len(table.hs))
    scale = (1.0 / table.stride.to(dt))[levels]
    h_l = table.h[levels]
    w_l = table.w[levels]

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


def _gather_rows_core(flat: torch.Tensor, bases: torch.Tensor,
                      pitches: torch.Tensor, table: LevelTable,
                      boxes: torch.Tensor, levels: torch.Tensor,
                      img: torch.Tensor, resolution: int,
                      sampling_ratio: int) -> torch.Tensor:
    """Exact gather ROIAlign of M (box, level, image) triples against the
    flattened (rows*cols, C) buffer -> (M, R, R, C) float32.

    ``bases``: (L,) flat-element base of level l's section; ``pitches``:
    (L,) row pitch in elements; image ``img`` of level l starts
    ``img * table.hp[l]`` rows further.  All on the boxes' device.
    """
    dev, dt = boxes.device, boxes.dtype
    c = flat.shape[-1]

    def per_box(values):
        return values[levels][:, None, None, None, None]

    scales = 1.0 / table.stride.to(dt)
    ys, xs = _sample_grid(boxes, scales[levels], resolution, sampling_ratio)
    h, w, hp, wp = (per_box(table.h), per_box(table.w), per_box(table.hp),
                    per_box(pitches))
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


def multilevel_roi_align_gather(fmaps: Sequence[torch.Tensor],
                                boxes: torch.Tensor, resolution: int,
                                strides: Sequence[int],
                                sampling_ratio: int = 2) -> torch.Tensor:
    """Gather-based multilevel ROIAlign of one image (the oracle of the
    patch poolers): ``fmaps[l]`` (H_l, W_l, C), ``boxes`` (N, 4) ->
    (N, R, R, C) float32.  Every level is flattened to rows of one
    (sum HW, C) buffer and each bilinear corner is one row gather."""
    c = fmaps[0].shape[-1]
    table = level_table([f.shape[0] for f in fmaps],
                        [f.shape[1] for f in fmaps], strides, 1, boxes.device)
    flat = torch.cat([f.reshape(-1, c) for f in fmaps], dim=0)
    sizes = table.h * table.w
    levels = assign_fpn_levels(boxes, min_level=2, max_level=1 + len(fmaps))
    img = torch.zeros_like(levels)
    return _gather_rows_core(flat, torch.cumsum(sizes, 0) - sizes, table.w,
                             table, boxes, levels, img, resolution,
                             sampling_ratio)


PoolFn = Callable[..., torch.Tensor]


class BoxGeometry(NamedTuple):
    """Per-box patch geometry of one pooling call (N boxes in all)."""
    flat_boxes: torch.Tensor  # (N, 4)
    img: torch.Tensor         # (N,) int64 image index
    levels: torch.Tensor      # (N,) int64 FPN level (0-based)
    oy: torch.Tensor          # (N,) int64 window row in the level's map
    ox_al: torch.Tensor       # (N,) int64 window column, multiple of 8
    sy: torch.Tensor          # (N, R*S) sample rows relative to oy
    sx_al: torch.Tensor       # (N, R*S) sample columns relative to ox_al
    valid_y: torch.Tensor     # (N, R*S) bool
    valid_x: torch.Tensor     # (N, R*S) bool
    ay: torch.Tensor          # (N, R, PATCH) float32
    ax: torch.Tensor          # (N, R, CPATCH) float32
    overflow: torch.Tensor    # (N,) bool: samples outspan the 48-row window
    prio: torch.Tensor        # (N,) float32 exact-tail priority: 2 * overflow
    hs: np.ndarray            # (L,) level heights
    ws: np.ndarray            # (L,) level widths
    table: LevelTable


def _box_geometry(flat_boxes: torch.Tensor, img: torch.Tensor,
                  table: LevelTable, resolution: int,
                  sampling_ratio: int) -> BoxGeometry:
    """The plain version of the geometry kernel (``roi_geometry``)."""
    levels, oy, ox, sy, sx, valid_y, valid_x = _patch_pool_prep(
        flat_boxes, table, resolution, sampling_ratio)
    ox_al = (ox // 8) * 8
    sx_al = sx + (ox - ox_al).to(flat_boxes.dtype)[:, None]
    ay, ax = _fold_hats(sy, sx_al, valid_y, valid_x, resolution,
                        sampling_ratio, CPATCH)
    overflow = ((sy.amax(dim=1) > PATCH - 1)
                | (sx_al.amax(dim=1) > CPATCH - 1))
    return BoxGeometry(flat_boxes=flat_boxes, img=img, levels=levels, oy=oy,
                       ox_al=ox_al, sy=sy, sx_al=sx_al, valid_y=valid_y,
                       valid_x=valid_x, ay=ay.contiguous(),
                       ax=ax.contiguous(), overflow=overflow,
                       prio=overflow.to(torch.float32) * 2.0, hs=table.hs,
                       ws=table.ws, table=table)


def _window_index(g: BoxGeometry, flat: bool) -> torch.Tensor:
    """The plain version of the geometry kernel's window index: with
    ``flat`` K1's (2, N) int32 [absolute window row; column], else K5's
    (N, 3) int32 meta [level, img*(H_l+PATCH)+oy, ox_al]."""
    t = g.table
    row = g.img * t.hp[g.levels] + g.oy
    if flat:
        return torch.stack([t.lvl_base[g.levels] + row, g.ox_al]).to(
            torch.int32)
    return torch.stack([g.levels, row, g.ox_al], dim=1).to(torch.int32)


def box_geometry(boxes: torch.Tensor, table: LevelTable, resolution: int,
                 sampling_ratio: int, flat: bool
                 ) -> Tuple[BoxGeometry, torch.Tensor]:
    """Every box's patch geometry and window index (:func:`_window_index`)
    of a (B, N, 4) batch: one launch of the geometry kernel on the card,
    bit-equal to the plain version, which a tensor on the CPU takes."""
    b, n = boxes.shape[0], boxes.shape[1]
    flat_boxes = boxes.reshape(b * n, 4)
    if boxes.device.type != "cpu":
        *fields, index = roi_geometry(flat_boxes.contiguous(), table.packed,
                                      n, resolution, sampling_ratio, PATCH,
                                      flat)
        return BoxGeometry(flat_boxes, *fields, hs=table.hs, ws=table.ws,
                           table=table), index
    img = torch.arange(b, device=boxes.device).repeat_interleave(n)
    g = _box_geometry(flat_boxes, img, table, resolution, sampling_ratio)
    return g, _window_index(g, flat)


def _batched_table(fmaps: Sequence[torch.Tensor], boxes: torch.Tensor,
                   strides: Sequence[int]) -> LevelTable:
    return level_table([f.shape[1] for f in fmaps],
                       [f.shape[2] for f in fmaps], strides, boxes.shape[0],
                       boxes.device)


class FlatPoolInputs(NamedTuple):
    """What a flat pooling call (K1) needs, from one batch of boxes."""
    kcat: torch.Tensor        # (sum_l B*(H_l+PATCH), W_max+CPATCH, C)
    rows: torch.Tensor        # (B*N,) int32 absolute window row
    cols: torch.Tensor        # (B*N,) int32 window column, multiple of 8
    lvl_base: np.ndarray      # (L,) first kcat row of each level's sections
    geom: BoxGeometry

    @property
    def ay(self) -> torch.Tensor:
        return self.geom.ay

    @property
    def ax(self) -> torch.Tensor:
        return self.geom.ax


def flat_pool_inputs(fmaps: Sequence[torch.Tensor], boxes: torch.Tensor,
                     resolution: int, strides: Sequence[int],
                     sampling_ratio: int = 2) -> FlatPoolInputs:
    """Build the level-concatenated buffer and every box's window origin
    and hat matrices (see :func:`multilevel_roi_align_batched`)."""
    b = boxes.shape[0]
    c = fmaps[0].shape[-1]
    table = _batched_table(fmaps, boxes, strides)
    g, index = box_geometry(boxes, table, resolution, sampling_ratio,
                            flat=True)
    hs, ws = g.hs, g.ws

    # ONE uniform-width buffer for every (level, image) section: image b of
    # level l starts at row lvl_base[l] + b * (H_l + PATCH); the bottom and
    # right zero padding keeps every window inside its own section
    wmax = int(ws.max()) + CPATCH
    sec_rows = (hs + PATCH) * b
    lvl_base = np.concatenate([[0], np.cumsum(sec_rows)[:-1]])
    kcat = torch.zeros((int(sec_rows.sum()), wmax, c), dtype=fmaps[0].dtype,
                       device=boxes.device)
    for l, f in enumerate(fmaps):
        h, w = int(hs[l]), int(ws[l])
        sec = kcat[int(lvl_base[l]):int(lvl_base[l] + sec_rows[l])]
        sec.view(b, h + PATCH, wmax, c)[:, :h, :w] = f
    return FlatPoolInputs(kcat=kcat, rows=index[0], cols=index[1],
                          lvl_base=lvl_base, geom=g)


class LevelPoolInputs(NamedTuple):
    """What a per-level pooling call (K5) needs, from one batch of boxes."""
    kpadded: Tuple[torch.Tensor, ...]   # per level (B*(H_l+PATCH), W_l+CPATCH, C)
    meta: torch.Tensor        # (B*N, 3) int32 [level, img*(H_l+PATCH)+oy, ox_al]
    geom: BoxGeometry

    @property
    def ay(self) -> torch.Tensor:
        return self.geom.ay

    @property
    def ax(self) -> torch.Tensor:
        return self.geom.ax


def level_pool_inputs(fmaps: Sequence[torch.Tensor], boxes: torch.Tensor,
                      resolution: int, strides: Sequence[int],
                      sampling_ratio: int = 2) -> LevelPoolInputs:
    """Build the per-level row-concatenated buffers (image b of level l at
    rows [b*(H_l+PATCH), (b+1)*(H_l+PATCH)), no padding to a common width)
    and every box's ``meta`` row and hat matrices."""
    b = boxes.shape[0]
    c = fmaps[0].shape[-1]
    table = _batched_table(fmaps, boxes, strides)
    g, meta = box_geometry(boxes, table, resolution, sampling_ratio,
                           flat=False)
    kpadded = []
    for l, f in enumerate(fmaps):
        h, w = int(g.hs[l]), int(g.ws[l])
        buf = torch.zeros((b * (h + PATCH), w + CPATCH, c), dtype=f.dtype,
                          device=boxes.device)
        buf.view(b, h + PATCH, w + CPATCH, c)[:, :h, :w] = f
        kpadded.append(buf)
    return LevelPoolInputs(kpadded=tuple(kpadded), meta=meta, geom=g)


def _exact_tail_reference(buffers: Sequence[torch.Tensor], flat: bool,
                          g: BoxGeometry, flag: torch.Tensor,
                          idx: torch.Tensor, out: torch.Tensor,
                          sel: Optional[torch.Tensor], resolution: int,
                          sampling_ratio: int) -> None:
    """The plain version of the exact-tail kernel (``roi_exact_tail``): the
    boxes ``b * N + idx[b, j]`` of the (B, m) top-k pooled through
    :func:`_gather_rows_core` from the layout's buffers, written into
    ``out`` and ``sel`` where ``flag > 0``."""
    b = idx.shape[0]
    n = g.levels.shape[0] // b
    t = g.table
    c = buffers[0].shape[-1]
    rows = (torch.arange(b, device=idx.device)[:, None] * n + idx).reshape(-1)
    take = (flag > 0).reshape(-1)
    if flat:
        src, pitches = buffers[0].reshape(-1, c), t.flat_pitch
        bases = t.lvl_base * t.flat_pitch
    else:
        src, pitches = torch.cat([k.reshape(-1, c) for k in buffers]), \
            t.level_pitch
        sizes = t.n_images * t.hp * t.level_pitch
        bases = torch.cumsum(sizes, 0) - sizes
    fb = _gather_rows_core(src, bases, pitches, t, g.flat_boxes[rows],
                           g.levels[rows], g.img[rows], resolution,
                           sampling_ratio)
    out[rows] = torch.where(take[:, None, None, None], fb.to(out.dtype),
                            out[rows])
    if sel is not None:
        sel[rows] = take


def exact_tail(buffers: Sequence[torch.Tensor], flat: bool, g: BoxGeometry,
               flag: torch.Tensor, idx: torch.Tensor, out: torch.Tensor,
               sel: Optional[torch.Tensor], resolution: int,
               sampling_ratio: int) -> None:
    """Re-pool exactly, in place, the boxes that a per-image (B, m) top-k
    ``(flag, idx)`` picked (those with ``flag > 0``): their rows of ``out``
    (B*N, R, R, C) and their ``sel`` flags.  ``buffers``: K1's buffer with
    ``flat``, else the per-level buffers.  One launch of the exact-tail
    kernel on the card; a tensor on the CPU takes the plain version."""
    if out.device.type != "cpu":
        roi_exact_tail(buffers, flat, g.table.packed, g.flat_boxes, flag,
                       idx, out, sel, resolution, sampling_ratio)
    else:
        _exact_tail_reference(buffers, flat, g, flag, idx, out, sel,
                              resolution, sampling_ratio)


class ResidentPoolInputs(NamedTuple):
    """What a resident pooling call (K6) needs: image-relative clamped
    origins, hats folded for them, each image's boxes padded to a chunk
    multiple."""
    kpadded: Tuple[torch.Tensor, ...]
    meta: torch.Tensor        # (B*(N+pad), 3) int32 [level, r0, c0]
    ay: torch.Tensor          # (B*(N+pad), R, PATCH) float32
    ax: torch.Tensor          # (B*(N+pad), R, CPATCH) float32
    chunk: int
    n_images: int
    c_split: int
    pad_per: int              # padding boxes at the end of each image's list


def resident_c_split(kpadded: Sequence[torch.Tensor], n_images: int) -> int:
    """The smallest C-split (1, 2, 4, ... with C % c_split == 0) whose
    per-image sections fit the share of L2 that K6 counts on; raises if none
    does (the pooler does not quietly change kernels)."""
    c = kpadded[0].shape[-1]
    hs = [f.shape[0] // n_images - PATCH for f in kpadded]
    ws = [f.shape[1] - CPATCH for f in kpadded]
    itemsize = kpadded[0].element_size()
    budget = resident_l2_budget(kpadded[0].device)
    s = 1
    while c % s == 0:
        if resident_section_bytes(hs, ws, c // s, PATCH, itemsize) <= budget:
            return s
        s *= 2
    raise RuntimeError(
        f"TD_ROI_RESIDENT=1: no C-split of C={c} brings one image's sections "
        f"({resident_section_bytes(hs, ws, c, PATCH, itemsize)} bytes whole) "
        f"under the L2 budget of {budget} bytes; unset TD_ROI_RESIDENT")


def resident_pool_inputs(p: LevelPoolInputs, resolution: int,
                         sampling_ratio: int, n_images: int,
                         chunk: Optional[int] = None,
                         c_split: Optional[int] = None) -> ResidentPoolInputs:
    """From the per-level inputs to the resident pooler's: clamp the window
    origins into the unpadded sections ((max(H_l, PATCH), max(W_l, CPATCH)):
    the level table's ``max_r0``, ``max_c0``), shift the patch-relative
    sample coordinates by the clamp and fold the hat matrices again (a
    clamped window still holds the whole in-image span of a fitting box),
    then pad each image's boxes to a multiple of ``chunk`` with zero hats
    and ``meta`` 0."""
    g = p.geom
    n = g.levels.shape[0]
    n_per = n // n_images
    if c_split is None:
        c_split = resident_c_split(p.kpadded, n_images)
    r0 = torch.minimum(g.oy, g.table.max_r0[g.levels])
    c0 = torch.minimum(g.ox_al, g.table.max_c0[g.levels])
    sy2 = g.sy + (g.oy - r0).to(g.sy.dtype)[:, None]
    sx2 = g.sx_al + (g.ox_al - c0).to(g.sx_al.dtype)[:, None]
    ay, ax = _fold_hats(sy2, sx2, g.valid_y, g.valid_x, resolution,
                        sampling_ratio, CPATCH)
    meta = torch.stack([g.levels, r0, c0], dim=1).to(torch.int32)
    if chunk is None:
        chunk = RESIDENT_CHUNKS[p.kpadded[0].dtype][resolution > 8]
    chunk = max(min(chunk, n_per), 1)
    pad_per = (-n_per) % chunk
    if pad_per:
        def pad_img(a):
            a = a.reshape((n_images, n_per) + a.shape[1:])
            pad = a.new_zeros((n_images, pad_per) + a.shape[2:])
            return torch.cat([a, pad], dim=1).reshape(
                (n_images * (n_per + pad_per),) + a.shape[2:])
        meta, ay, ax = pad_img(meta), pad_img(ay), pad_img(ax)
    return ResidentPoolInputs(
        kpadded=p.kpadded, meta=meta.contiguous(), ay=ay.contiguous(),
        ax=ax.contiguous(), chunk=chunk, n_images=n_images, c_split=c_split,
        pad_per=pad_per)


def _launch_resident_kernel(p: LevelPoolInputs, resolution: int,
                            sampling_ratio: int, n_images: int
                            ) -> torch.Tensor:
    """Pool every box through K6 and cut each image's padding boxes off."""
    r = resident_pool_inputs(p, resolution, sampling_ratio, n_images)
    out = roi_pool_resident(r.kpadded, r.meta, r.ay, r.ax, resolution, PATCH,
                            r.chunk, r.n_images, r.c_split)
    if r.pad_per:
        n_per = out.shape[0] // n_images - r.pad_per
        out = out.reshape((n_images, n_per + r.pad_per) + out.shape[1:])
        out = out[:, :n_per].reshape((n_images * n_per,) + out.shape[2:])
    return out


def pooler_layout() -> str:
    """The buffer layout that ``TD_ROI_FLAT`` and ``TD_ROI_RESIDENT`` select
    now: ``"flat"`` (K1), ``"levels"`` (K5) or ``"resident"`` (K6)."""
    if os.environ.get("TD_ROI_RESIDENT", "0") == "1":
        return "resident"
    return "flat" if os.environ.get("TD_ROI_FLAT", "1") == "1" else "levels"


def pooler_libraries() -> Tuple[str, ...]:
    """The kernel libraries (``ops.kernels.roi_align.build`` names) that
    ``multilevel_roi_align_batched`` launches on the card under the layout
    the environment selects now: the geometry and exact-tail kernels and the
    layout's pooler; the resident layout pools a small patch class, where
    ``TD_ROI_SMALL`` turns one on, through K5."""
    layout = pooler_layout()
    if layout == "flat":
        return ("roi_pool_prep", "roi_pool_flat")
    if layout == "levels" or not any(     # the box and the mask pool
            _class_params(1, r)[0] for r in (7, 14)):
        return ("roi_pool_prep", f"roi_pool_{layout}")
    return ("roi_pool_prep", "roi_pool_resident", "roi_pool_levels")


def multilevel_roi_align_batched(fmaps: Sequence[torch.Tensor],
                                 boxes: torch.Tensor, resolution: int,
                                 strides: Sequence[int],
                                 sampling_ratio: int = 2,
                                 pool: Optional[PoolFn] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-batch multilevel ROIAlign: ``fmaps[l]`` (B, H_l, W_l, C) NHWC,
    ``boxes`` (B, N, 4) float32 -> ((B, N, R, R, C) in the feature dtype,
    (B, N) bool inexact mask).

    The layout of the feature buffers follows ``TD_ROI_FLAT`` (default 1)
    and ``TD_ROI_RESIDENT`` (default 0), read here at each call (see the
    module docstring): one zero-padded level-concatenated buffer pooled by
    K1, per-level buffers pooled by K5, or the per-level buffers pooled
    image by image by K6.  ``pool`` replaces the flat layout's pooler (pass
    ``roi_pool_patches_flat_reference`` for the plain version); it is not
    taken with another layout.

    One launch pools every box; with a small patch class on, the boxes that
    do not fit it pool again through the 48-row patch within a per-image
    budget; and boxes whose samples outspan even that window are re-pooled
    exactly through the gather tail, highest-scoring first, up to their
    per-image budget.  The rest stay truncated and are flagged.
    Geometries whose boxes could outspan the patch on every level pool every
    box through the gather path.  On the card the geometry and the gather
    tail are one kernel launch each (:func:`box_geometry`,
    :func:`exact_tail`) and the level geometry stays on the device
    (:func:`level_table`), so a call copies nothing from the host and waits
    for nothing.
    """
    b, n = boxes.shape[0], boxes.shape[1]
    c = fmaps[0].shape[-1]
    dev = boxes.device
    layout = pooler_layout()
    use_resident = layout == "resident"
    flat_layout = layout == "flat"
    if pool is not None and not flat_layout:
        raise ValueError("'pool' replaces the flat layout's pooler; it cannot "
                         "be given with TD_ROI_FLAT=0 or TD_ROI_RESIDENT=1")

    if flat_layout:
        pool = roi_pool_patches_flat if pool is None else pool
        p = flat_pool_inputs(fmaps, boxes, resolution, strides, sampling_ratio)
        g = p.geom
        buffers = (p.kcat,)

        def launch(sel, patch):
            return pool(p.kcat, p.rows[sel], p.cols[sel],
                        g.ay[sel][:, :, :patch].contiguous(),
                        g.ax[sel][:, :, :patch + 8].contiguous(), resolution,
                        patch)
    else:
        p = level_pool_inputs(fmaps, boxes, resolution, strides,
                              sampling_ratio)
        g = p.geom
        buffers = p.kpadded

        def launch(sel, patch):
            return roi_pool_patches(
                p.kpadded, p.meta[sel].contiguous(),
                g.ay[sel][:, :, :patch].contiguous(),
                g.ax[sel][:, :, :patch + 8].contiguous(), resolution, patch)

    def exact(out, flag, idx, sel=None):
        exact_tail(buffers, flat_layout, g, flag, idx, out, sel, resolution,
                   sampling_ratio)

    everything = slice(None)
    img_span = max(int(h) * s for h, s in zip(g.hs, strides))
    if img_span / strides[-1] > PATCH - 2:
        out = torch.empty((b * n, resolution, resolution, c),
                          dtype=fmaps[0].dtype, device=dev)
        exact(out, torch.ones(n, device=dev).expand(b, n),
              torch.arange(n, device=dev).expand(b, n))
        return (out.reshape(b, n, resolution, resolution, c),
                torch.zeros((b, n), dtype=torch.bool, device=dev))

    # hat weights beyond a FITTING box's span are exactly zero, so slicing
    # the hat matrices IS the small-patch pooling
    small, m_large, m_exact = _class_params(n, resolution)
    need_exact = g.overflow.reshape(b, n)      # outspans even the 48-patch
    inexact = need_exact.reshape(-1)
    prio = g.prio.reshape(b, n)
    if small:
        fits_small = ~((g.sy.amax(dim=1) > small - 1)
                       | (g.sx_al.amax(dim=1) > small + 8 - 1))
        need_large = ~fits_small.reshape(b, n) & ~need_exact
        out = launch(everything, small)
        sel_large = torch.zeros(b * n, dtype=torch.bool, device=dev)
        if m_large > 0:
            img_base = torch.arange(b, device=dev)[:, None] * n
            flag_l, idx_l = stable_topk(need_large.to(torch.float32), m_large)
            flat_l = (img_base + idx_l).reshape(-1)
            take_l = (flag_l > 0).reshape(-1)
            out_l = launch(flat_l, PATCH)
            out[flat_l] = torch.where(take_l[:, None, None, None],
                                      out_l.to(out.dtype), out[flat_l])
            sel_large[flat_l] = take_l
        # beyond-48 boxes first, then class-2 spillover the large budget
        # missed
        prio = (need_exact.to(torch.float32) * 2.0
                + (need_large & ~sel_large.reshape(b, n)).to(torch.float32))
        inexact = (inexact | need_large.reshape(-1)) & ~sel_large
    elif use_resident:
        out = _launch_resident_kernel(p, resolution, sampling_ratio, b)
    else:
        out = launch(everything, PATCH)

    if m_exact > 0:
        # ties break toward lower index == higher proposal score
        flag_e, idx_e = stable_topk(prio, m_exact)
        sel_exact = torch.zeros(b * n, dtype=torch.bool, device=dev)
        exact(out, flag_e, idx_e, sel_exact)
        inexact = inexact & ~sel_exact
    return (out.reshape(b, n, resolution, resolution, c),
            inexact.reshape(b, n))


def _window_pool_differentiable(fmaps: Sequence[torch.Tensor],
                                boxes: torch.Tensor, resolution: int,
                                strides: Sequence[int], sampling_ratio: int,
                                chunk: int = 128
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training pooler of one image, which autograd differentiates:
    each box slices one (PATCH, PATCH, C) window of the level-concatenated,
    zero-padded buffer and contracts it with its two hat matrices, ``chunk``
    boxes at a time.  Autograd keeps the window indices and the hats, not
    the windows.  -> ((N, R, R, C), (N,) bool overflow)."""
    c = fmaps[0].shape[-1]
    dev = boxes.device
    n = boxes.shape[0]
    hs = np.asarray([f.shape[0] for f in fmaps])
    ws = np.asarray([f.shape[1] for f in fmaps])
    flat = torch.cat([torch.nn.functional.pad(f, (0, 0, 0, PATCH, 0, PATCH))
                      .reshape(-1, c) for f in fmaps])
    wps = ws + PATCH
    bases = np.concatenate([[0], np.cumsum((hs + PATCH) * wps)[:-1]])
    levels, oy, ox, sy, sx, valid_y, valid_x = _patch_pool_prep(
        boxes, level_table(hs, ws, strides, 1, dev), resolution,
        sampling_ratio)
    overflow = (sy.amax(dim=1) > PATCH - 1) | (sx.amax(dim=1) > PATCH - 1)
    ay, ax = _fold_hats(sy, sx, valid_y, valid_x, resolution, sampling_ratio,
                        PATCH)
    ay, ax = ay.to(flat.dtype), ax.to(flat.dtype)
    span = torch.arange(PATCH, device=dev)
    starts = (torch.as_tensor(bases, device=dev)[levels][:, None]
              + (oy[:, None] + span) * torch.as_tensor(wps, device=dev)[
                  levels][:, None] + ox[:, None])                 # (N, PATCH)
    outs = [flat.new_zeros((0, resolution, resolution, c))]
    for k in range(0, n, chunk):
        windows = flat[starts[k:k + chunk, :, None] + span]  # (K, y, x, C)
        t = torch.einsum("kiy,kyxc->kixc", ay[k:k + chunk], windows)
        outs.append(torch.einsum("kjx,kixc->kijc", ax[k:k + chunk], t))
    return torch.cat(outs), overflow


def multilevel_roi_align(fmaps: Sequence[torch.Tensor], boxes: torch.Tensor,
                         resolution: int, strides: Sequence[int],
                         sampling_ratio: int = 2,
                         return_overflow: bool = False,
                         differentiable: bool = False):
    """Single-image multilevel ROIAlign: ``fmaps[l]`` (H_l, W_l, C),
    ``boxes`` (N, 4) -> (N, R, R, C) in the feature dtype, and with
    ``return_overflow`` the count of boxes left truncated.

    Every box pools through K5 ``roi_pool_patches`` from the per-level
    zero-padded maps (``meta = [level, oy, ox_al]``); up to
    ``FALLBACK_BUDGET`` boxes whose samples outspan the window are re-pooled
    through the gather path, lowest index first.  Geometries whose boxes
    could outspan the patch on every level pool through the gather path
    alone.  K5 defines no gradient: training passes ``differentiable=True``
    (the JAX caller's ``pallas=False``), which pools each box from a 48x48
    window with two einsums and takes the same gather fix-up, all in
    PyTorch operations that autograd differentiates.  The boxes get no
    gradient.
    """
    dtype = fmaps[0].dtype
    dev = boxes.device
    n = boxes.shape[0]
    img_span = max(f.shape[0] * s for f, s in zip(fmaps, strides))
    if img_span / strides[-1] > PATCH - 2:
        out = multilevel_roi_align_gather(fmaps, boxes, resolution, strides,
                                          sampling_ratio).to(dtype)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return (out, zero) if return_overflow else out

    if differentiable:
        boxes = boxes.detach()
        out, overflow = _window_pool_differentiable(
            fmaps, boxes, resolution, strides, sampling_ratio)
    else:
        p = level_pool_inputs([f[None] for f in fmaps], boxes[None],
                              resolution, strides, sampling_ratio)
        g = p.geom
        out = roi_pool_patches(p.kpadded, p.meta, g.ay, g.ax, resolution,
                               PATCH)
        overflow = g.overflow
    inexact = overflow
    m = min(FALLBACK_BUDGET, n)
    if m > 0:
        flag, idx = stable_topk(overflow.to(torch.float32), m)
        fb = multilevel_roi_align_gather(fmaps, boxes[idx], resolution,
                                         strides, sampling_ratio)
        take = flag > 0
        out = out.index_put((idx,), torch.where(
            take[:, None, None, None], fb.to(out.dtype), out[idx]))
        sel = torch.zeros(n, dtype=torch.bool, device=dev)
        sel[idx] = take
        inexact = overflow & ~sel
    if return_overflow:
        return out, inexact.sum().to(torch.int32)
    return out

