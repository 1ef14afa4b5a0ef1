"""K1, K5, K6 — the ROIAlign patch poolers: CUDA kernels, wrappers, plain
versions.

Each replaces one function of ``treedetection_tpu/ops/pallas/
roi_align_kernel.py`` and keeps its contract.  All three compute, per box,

    out[i] = ay[i] . window_i . ax[i]^T          -> out (N, R, R, C)

with ``ay`` (N, R, patch) and ``ax`` (N, R, patch+8) float32 hat matrices and
a (patch, patch+8, C) window of a float32 or bfloat16 NHWC feature buffer;
they differ in where the window comes from:

* K1 ``roi_pool_patches_flat(fcat, rows, cols, ay, ax, resolution, patch)``
  (``csrc/roi_pool_flat.cu``): one level- and image-concatenated buffer
  ``fcat`` (rows_total, W, C); ``rows``/``cols`` (N,) int32 window origins.
* K5 ``roi_pool_patches(fmaps_padded, meta, ay, ax, resolution, patch)``
  (``csrc/roi_pool_levels.cu``): up to four per-level buffers
  (B*(H_l+patch), W_l+patch+8, C); ``meta`` (N, 3) int32 [level, row, col].
* K6 ``roi_pool_resident(fmaps_padded, meta, ay, ax, resolution, patch,
  chunk, n_images, c_split)`` (``csrc/roi_pool_resident.cu``): K5's buffers
  and output, with boxes grouped by image, ``meta[:, 1]`` relative to the
  image's section, origins clamped into the section's unpadded corner and
  the channels taken in ``c_split`` blocks, so that one image's sections
  are the card's working set at a time.

Column origins are multiples of 8 in all three, as in the TPU kernels.

Two more kernels, in ``csrc/roi_pool_prep.cu``, do the batched pooler's work
around them on the card (``ops/roi_align.py``), where the JAX package leaves
it to XLA inside its jitted forward:

* :func:`roi_geometry` — every box's FPN level, window origin, sample
  coordinates, hat matrices, overflow flag, exact-tail priority and the
  window index of K1 (``rows``/``cols``) or K5 (``meta``), in one launch,
  bit-equal to the plain PyTorch version run on the card;
* :func:`roi_exact_tail` — the exact gather ROIAlign of the boxes a top-k
  picked, written into the pooled output in place.

Both read the pooler's per-level constants from a level table on the device
(``TABLE_COLUMNS``).

The sources (what bounds each kernel and its design are noted there) share
two device functions: ``pool_box`` (``csrc/roi_pool_window.cuh``) pools a box
in all three in float32; ``pool_box_bf16`` (``csrc/roi_pool_bf16.cuh``: the
hats' span, ``cp.async`` staging, ``mma.sync``) pools a box in all three in
bfloat16.  So K1, K5 and K6 are bit-equal on the same boxes in either dtype
(K6's refolded hats are K1's shifted by its clamp).  Each source is compiled
with nvcc for ``sm_90a`` at first use into the package's build directory
(named by a hash that covers the headers it includes) and bound with
ctypes.  For a CUDA tensor a wrapper launches its kernel or raises; only a
tensor that lies on the CPU takes the plain PyTorch version beside it
(``*_reference``), which the tests and ``chip_smoke.py`` hold the kernel
against.

Rounding, as in the TPU kernels (``roi_align_kernel.py:129-138``, ``:231-238``,
``:377-388``): the hats are rounded to the feature dtype; ``t = A_y . window``
is accumulated in float32 and rounded to the feature dtype; the output
``t . A_x^T`` is accumulated in float32 and rounded once.  For float32
features each rounding is the identity.  The kernels and the plain versions
round at the same three points (:func:`contract_window`), so they differ
only where another summation order flips a rounding.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Sequence

import torch

from treedetection_tpu_torch.build import build_shared_library, nvcc_path
from treedetection_tpu_torch.utils.profiling import span

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
RESOLUTIONS = (7, 14)
MAX_LEVELS = 4
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Share of the card's L2 cache that K6's per-(image, C-block) sections may
# take (csrc/roi_pool_resident.cu says why a half), and the L2 size assumed
# for a tensor on the CPU (the H100's), so that a CPU run takes the C-split
# the card would.
RESIDENT_L2_SHARE = 0.5
H100_L2_BYTES = 50 * 1024 * 1024

# Columns of the pooler's level table, one row per FPN level, in the order
# csrc/roi_pool_prep.cu reads them: the level's height and width, the rows of
# one image's section (h + patch), the first row of the level's sections in
# K1's buffer, K1's buffer width, the level buffer's width (K5, K6), the
# stride, and the largest window origin K6 may take (row, column).
TABLE_COLUMNS = ("h", "w", "hp", "lvl_base", "flat_pitch", "level_pitch",
                 "stride", "max_r0", "max_c0")

# kernel launches since the last reset (plain counts; chip_smoke.py reads
# them to show the main path went through each kernel)
launches = 0            # K1
launches_patches = 0    # K5
launches_resident = 0   # K6
launches_geometry = 0   # roi_geometry
launches_exact_tail = 0  # roi_exact_tail
_count_lock = threading.Lock()


def _count(name: str) -> None:
    """One launch more on the counter ``name``: a Predictor over several
    devices launches from one thread per device."""
    with _count_lock:
        globals()[name] += 1

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# library (csrc/<name>.cu) -> its C entry points and their argument types
_ARG_TYPES = {
    "roi_pool_flat": {
        "td_roi_pool_flat": [_P] * 6 + [_I] * 7 + [_P]},
    "roi_pool_levels": {
        "td_roi_pool_levels": [_P] * 3 + [_I] + [_P] * 4 + [_I] * 5 + [_P]},
    "roi_pool_resident": {
        "td_roi_pool_resident": [_P] * 3 + [_I] + [_P] * 4 + [_I] * 8
        + [_P]},
    "roi_pool_prep": {
        "td_roi_geometry": [_P, _P] + [_I] * 7 + [_P] * 14,
        "td_roi_exact_tail": [_P, _P, _I, _I, _P, _P, _L, _P, _L]
        + [_I] * 7 + [_P] * 3},
}
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def build(name: str = "roi_pool_flat") -> Path:
    """Compile (or find) one kernel library (``roi_pool_flat``,
    ``roi_pool_levels``, ``roi_pool_resident`` or ``roi_pool_prep``);
    returns its path.  The compiler's output (``-Xptxas -v``
    register/shared-memory report) is kept beside it as ``<name>.log``."""
    if name not in _ARG_TYPES:
        raise ValueError(f"unknown kernel library {name!r}")
    return build_shared_library(name, [_CSRC / f"{name}.cu"],
                                [nvcc_path()] + NVCC_FLAGS)


def _get_fn(name: str, entry: str = ""):
    """The C entry point ``entry`` (default ``td_<name>``) of the kernel
    library ``name``, built and loaded at first use."""
    if name not in _libs:
        with _lock:
            if name not in _libs:
                lib = ctypes.CDLL(str(build(name)))
                for fn_name, argtypes in _ARG_TYPES[name].items():
                    fn = getattr(lib, fn_name)
                    fn.restype = ctypes.c_int
                    fn.argtypes = argtypes
                _libs[name] = lib
    return getattr(_libs[name], entry or f"td_{name}")


def _check_common(buffers: Sequence[torch.Tensor], index_tensors, ay, ax,
                  resolution: int, patch: int) -> None:
    """What every pooler requires: float32/bfloat16 3-D contiguous buffers of
    one dtype, device and C; int32 indices; float32 hats of the right shape;
    everything contiguous and on one device."""
    first = buffers[0]
    if first.dtype not in _DTYPE_CODE:
        raise TypeError(f"features must be float32 or bfloat16, got "
                        f"{first.dtype}")
    for f in buffers:
        if f.dim() != 3:
            raise ValueError(f"a feature buffer must be (rows, W, C), got "
                             f"{tuple(f.shape)}")
        if f.dtype != first.dtype or f.shape[-1] != first.shape[-1]:
            raise ValueError("feature buffers must share one dtype and C")
        if f.shape[0] < patch or f.shape[1] < patch + 8:
            raise ValueError(f"feature buffer {tuple(f.shape)} is smaller "
                             f"than one ({patch}, {patch + 8}) window")
    n = ay.shape[0]
    shapes = {"ay": (ay, (n, resolution, patch), torch.float32),
              "ax": (ax, (n, resolution, patch + 8), torch.float32)}
    for name, (t, width) in index_tensors.items():
        shapes[name] = (t, (n,) + width, torch.int32)
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    named = [(f"buffer {i}", f) for i, f in enumerate(buffers)] + \
        [(name, t) for name, (t, _, _) in shapes.items()]
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, the features on "
                             f"{first.device}")


def _check_cuda(t: torch.Tensor, resolution: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    if resolution not in RESOLUTIONS:
        raise ValueError(f"the kernel is built for resolutions {RESOLUTIONS}, "
                         f"got {resolution}")


def hat_spans(ay: torch.Tensor, ax: torch.Tensor) -> torch.Tensor:
    """(N, 4) int64 ``[y_lo, y_hi, x_lo, x_hi]``: the window rows where any
    row of ``ay[i]`` is nonzero and the columns where any row of ``ax[i]``
    is, inclusive.  Only these cells of a box's window carry weight.  A box
    with an all-zero ``ay[i]`` or ``ax[i]`` pools to zero and gets the empty
    span ``[0, -1, 0, -1]``."""
    def span(nz):                                 # (N, L) bool
        idx = torch.arange(nz.shape[1], device=nz.device)
        lo = torch.where(nz, idx, nz.shape[1]).amin(dim=1)
        hi = torch.where(nz, idx, -1).amax(dim=1)
        return lo, hi

    y_lo, y_hi = span((ay != 0).any(dim=1))
    x_lo, x_hi = span((ax != 0).any(dim=1))
    spans = torch.stack([y_lo, y_hi, x_lo, x_hi], dim=1)
    empty = ((y_hi < 0) | (x_hi < 0))[:, None]
    return torch.where(empty, torch.tensor([0, -1, 0, -1], device=ay.device),
                       spans)


# --- K1: one flat buffer -------------------------------------------------------

def _check_bf16_kernel(buffers: Sequence[torch.Tensor], patch: int) -> None:
    """What ``pool_box_bf16`` needs: C a multiple of 8, a patch of 1 to 48
    rows and 16-byte aligned buffers (``cp.async`` copies 16 bytes)."""
    c = buffers[0].shape[-1]
    misaligned = [f.data_ptr() for f in buffers if f.data_ptr() % 16]
    if c % 8 or not 1 <= patch <= 48 or misaligned:
        raise ValueError(
            f"the bfloat16 kernel needs C a multiple of 8, a patch of 1 to 48 "
            f"rows and 16-byte aligned buffers; got C={c}, patch={patch}, "
            f"misaligned addresses {[hex(a) for a in misaligned]}")


def roi_pool_patches_flat(fcat: torch.Tensor, rows: torch.Tensor,
                          cols: torch.Tensor, ay: torch.Tensor,
                          ax: torch.Tensor, resolution: int,
                          patch: int = 48) -> torch.Tensor:
    """Pool N boxes -> (N, R, R, C) from one level-concatenated buffer.

    On the card, float32 features take ``pool_box`` and bfloat16 features
    ``pool_box_bf16``, which needs C a multiple of 8, ``patch`` at most 48
    and a 16-byte aligned ``fcat``; other bfloat16 inputs raise."""
    _check_common([fcat], {"rows": (rows, ()), "cols": (cols, ())}, ay, ax,
                  resolution, patch)
    n, c = rows.shape[0], fcat.shape[-1]
    if n and fcat.device.type == "cuda":   # checked on the card, no sync
        torch._assert_async((cols % 8 == 0).all(),
                            "cols must be multiples of 8")
    elif n and bool((cols % 8 != 0).any()):
        raise ValueError("cols must be multiples of 8")
    if fcat.device.type == "cpu":
        return roi_pool_patches_flat_reference(fcat, rows, cols, ay, ax,
                                               resolution, patch)
    _check_cuda(fcat, resolution)
    if fcat.dtype == torch.bfloat16:
        _check_bf16_kernel([fcat], patch)
    out = torch.empty((n, resolution, resolution, c), dtype=fcat.dtype,
                      device=fcat.device)
    if n == 0:
        return out
    fn = _get_fn("roi_pool_flat")
    with torch.cuda.device(fcat.device):
        stream = torch.cuda.current_stream(fcat.device).cuda_stream
        rc = fn(fcat.data_ptr(), rows.data_ptr(), cols.data_ptr(),
                ay.data_ptr(), ax.data_ptr(), out.data_ptr(), n, resolution,
                patch, fcat.shape[0], fcat.shape[1], c,
                _DTYPE_CODE[fcat.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"td_roi_pool_flat failed with CUDA error {rc}")
    _count("launches")
    return out


def contract_window(ay: torch.Tensor, ax: torch.Tensor, win: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """``ay`` (k, R, P), ``ax`` (k, R, X) float32 hats and ``win`` (k, P, X, C)
    windows -> (k, R, R, C) in ``dtype``, rounded where the TPU kernels round:
    the hats and ``t`` to ``dtype``, both contractions in float32."""
    a_y = ay.to(dtype).float()
    a_x = ax.to(dtype).float()
    t = torch.einsum("kiy,kyxc->kixc", a_y, win.float()).to(dtype).float()
    return torch.einsum("kjx,kixc->kijc", a_x, t).to(dtype)


def roi_pool_patches_flat_reference(fcat: torch.Tensor, rows: torch.Tensor,
                                    cols: torch.Tensor, ay: torch.Tensor,
                                    ax: torch.Tensor, resolution: int,
                                    patch: int = 48,
                                    chunk: int = 64) -> torch.Tensor:
    """Plain PyTorch version: gather each box's window, then the two
    contractions of :func:`contract_window`, chunked over boxes (all windows
    at once would not fit)."""
    n, c = rows.shape[0], fcat.shape[-1]
    out = torch.empty((n, resolution, resolution, c), dtype=fcat.dtype,
                      device=fcat.device)
    ar_y = torch.arange(patch, device=fcat.device)
    ar_x = torch.arange(patch + 8, device=fcat.device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        ry = rows[s:e].long()[:, None] + ar_y                 # (k, patch)
        cx = cols[s:e].long()[:, None] + ar_x                 # (k, patch+8)
        win = fcat[ry[:, :, None], cx[:, None, :]]            # (k, P, P+8, C)
        out[s:e] = contract_window(ay[s:e], ax[s:e], win, fcat.dtype)
    return out


# --- K5: per-level buffers -----------------------------------------------------

def _check_meta(meta: torch.Tensor, n_levels: int, *extra: torch.Tensor):
    """Raise unless every ``meta[:, 0]`` is a level in [0, n_levels) and
    every ``meta[:, 2]`` a multiple of 8; returns the host values of the
    int32 0-d tensors ``extra``.  Everything is reduced on the tensors'
    device and fetched together in four launches, so a call on the card
    pays one synchronisation and little host time for its value checks."""
    lo, hi = torch.aminmax(meta[:, 0])
    with span("sync.k5_meta"):
        lo, hi, odd, *rest = torch.stack(
            [lo, hi, (meta[:, 2] & 7).amax(), *extra]).tolist()
    if lo < 0 or hi >= n_levels:
        raise ValueError(f"meta[:, 0] must be a level in [0, {n_levels})")
    if odd:
        raise ValueError("meta[:, 2] must be multiples of 8")
    return rest


def _check_levels(fmaps_padded, meta, ay, ax, resolution, patch) -> None:
    """The shapes, types and devices of a per-level pooling call (no value
    is read)."""
    if not 1 <= len(fmaps_padded) <= MAX_LEVELS:
        raise ValueError(f"1 to {MAX_LEVELS} level buffers, got "
                         f"{len(fmaps_padded)}")
    _check_common(list(fmaps_padded), {"meta": (meta, (3,))}, ay, ax,
                  resolution, patch)


def _level_arrays(fmaps_padded):
    """The level buffers' base pointers, row counts and widths as C arrays."""
    n = len(fmaps_padded)
    return ((ctypes.c_void_p * n)(*[f.data_ptr() for f in fmaps_padded]),
            (ctypes.c_int * n)(*[f.shape[0] for f in fmaps_padded]),
            (ctypes.c_int * n)(*[f.shape[1] for f in fmaps_padded]))


def roi_pool_patches(fmaps_padded: Sequence[torch.Tensor], meta: torch.Tensor,
                     ay: torch.Tensor, ax: torch.Tensor, resolution: int,
                     patch: int = 48) -> torch.Tensor:
    """Pool N boxes -> (N, R, R, C), each from the level buffer
    ``fmaps_padded[meta[i, 0]]`` at row ``meta[i, 1]``, column
    ``meta[i, 2]``.

    On the card, as :func:`roi_pool_patches_flat`: float32 features take
    ``pool_box``, bfloat16 features ``pool_box_bf16``, which needs C a
    multiple of 8, ``patch`` at most 48 and every level buffer 16-byte
    aligned; other bfloat16 inputs raise."""
    _check_levels(fmaps_padded, meta, ay, ax, resolution, patch)
    if meta.shape[0]:
        _check_meta(meta, len(fmaps_padded))
    first = fmaps_padded[0]
    if first.device.type == "cpu":
        return roi_pool_patches_reference(fmaps_padded, meta, ay, ax,
                                          resolution, patch)
    _check_cuda(first, resolution)
    if first.dtype == torch.bfloat16:
        _check_bf16_kernel(fmaps_padded, patch)
    n, c = meta.shape[0], first.shape[-1]
    out = torch.empty((n, resolution, resolution, c), dtype=first.dtype,
                      device=first.device)
    if n == 0:
        return out
    fn = _get_fn("roi_pool_levels")
    bases, rows, widths = _level_arrays(fmaps_padded)
    with torch.cuda.device(first.device):
        stream = torch.cuda.current_stream(first.device).cuda_stream
        rc = fn(bases, rows, widths, len(fmaps_padded), meta.data_ptr(),
                ay.data_ptr(), ax.data_ptr(), out.data_ptr(), n, resolution,
                patch, c, _DTYPE_CODE[first.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"td_roi_pool_levels failed with CUDA error {rc}")
    _count("launches_patches")
    return out


def _pool_windows(fmaps_padded, level, rows, cols, ay, ax, out, patch,
                  channels=slice(None), chunk: int = 64) -> None:
    """Plain pooling shared by K5's and K6's plain versions: for every box
    gather the (patch, patch+8) window at (rows[i], cols[i]) of its level's
    buffer, restricted to ``channels``, contract it with the hats
    (:func:`contract_window`) and write ``out[i, :, :, channels]``."""
    dev = out.device
    ar_y = torch.arange(patch, device=dev)
    ar_x = torch.arange(patch + 8, device=dev)
    for l, f in enumerate(fmaps_padded):
        idx = torch.nonzero(level == l).reshape(-1)
        for s in range(0, idx.numel(), chunk):
            sel = idx[s:s + chunk]
            ry = rows[sel][:, None] + ar_y                     # (k, patch)
            cx = cols[sel][:, None] + ar_x                     # (k, patch+8)
            win = f[ry[:, :, None], cx[:, None, :]][..., channels]
            out[sel, :, :, channels] = contract_window(ay[sel], ax[sel], win,
                                                       out.dtype)


def roi_pool_patches_reference(fmaps_padded: Sequence[torch.Tensor],
                               meta: torch.Tensor, ay: torch.Tensor,
                               ax: torch.Tensor, resolution: int,
                               patch: int = 48) -> torch.Tensor:
    """Plain PyTorch version of K5: level by level, gather each box's
    window, then the two contractions of :func:`contract_window`."""
    first = fmaps_padded[0]
    out = torch.zeros((meta.shape[0], resolution, resolution,
                       first.shape[-1]), dtype=first.dtype,
                      device=first.device)
    m = meta.long()
    _pool_windows(fmaps_padded, m[:, 0], m[:, 1], m[:, 2], ay, ax, out, patch)
    return out


# --- K6: image-resident sections ----------------------------------------------

def resident_section_bytes(hs, ws, c_blk: int, patch: int,
                           itemsize: int) -> int:
    """Bytes of one image's level sections for one C-block: what K6 counts
    on finding in L2 while it serves that image.  Sections hold the UNPADDED
    level, (max(H_l, patch), max(W_l, patch+8)) each."""
    cpatch = patch + 8
    return sum(max(int(h), patch) * max(int(w), cpatch) * c_blk * itemsize
               for h, w in zip(hs, ws))


def resident_l2_budget(device: torch.device) -> int:
    """Bytes of L2 that K6's sections may take on ``device``."""
    if device.type == "cuda":
        l2 = torch.cuda.get_device_properties(device).L2_cache_size
    else:
        l2 = H100_L2_BYTES
    return int(l2 * RESIDENT_L2_SHARE)


def resident_geometry(fmaps_padded, n_images: int, patch: int):
    """-> (src_hs, sec_hs, sec_ws): rows of one image's section in each
    buffer, and the unpadded corner of it that windows may read."""
    cpatch = patch + 8
    src_hs = [f.shape[0] // n_images for f in fmaps_padded]
    sec_hs = [max(h - patch, patch) for h in src_hs]
    sec_ws = [max(f.shape[1] - cpatch, cpatch) for f in fmaps_padded]
    return src_hs, sec_hs, sec_ws


def _check_resident(fmaps_padded, meta, ay, ax, resolution, patch, chunk,
                    n_images, c_split) -> None:
    _check_levels(fmaps_padded, meta, ay, ax, resolution, patch)
    n, c = meta.shape[0], fmaps_padded[0].shape[-1]
    if n_images < 1 or n % n_images:
        raise ValueError(f"{n} boxes do not divide into {n_images} images")
    if chunk < 1 or (n // n_images) % chunk:
        raise ValueError(f"{n // n_images} boxes per image are not a "
                         f"multiple of chunk {chunk}: pad each image's boxes")
    if c_split < 1 or c % c_split:
        raise ValueError(f"C={c} does not divide into {c_split} blocks")
    for f in fmaps_padded:
        if f.shape[0] % n_images:
            raise ValueError(f"buffer rows {f.shape[0]} do not divide into "
                             f"{n_images} image sections")
    if n:
        _, sec_hs, sec_ws = resident_geometry(fmaps_padded, n_images, patch)
        lvl = meta[:, 0].long().clamp(0, len(fmaps_padded) - 1)
        with span("sync.k6_bounds"):
            max_r = torch.tensor(sec_hs, device=meta.device)[lvl] - patch
        with span("sync.k6_bounds"):
            max_c = torch.tensor(sec_ws, device=meta.device)[lvl] - (patch + 8)
        outside = ((meta[:, 1] < 0) | (meta[:, 1] > max_r) | (meta[:, 2] < 0)
                   | (meta[:, 2] > max_c)).any().to(meta.dtype)
        if _check_meta(meta, len(fmaps_padded), outside)[0]:
            raise ValueError("window origins must be image-relative and "
                             "clamped into the unpadded sections")


def roi_pool_resident(fmaps_padded: Sequence[torch.Tensor], meta: torch.Tensor,
                      ay: torch.Tensor, ax: torch.Tensor, resolution: int,
                      patch: int, chunk: int, n_images: int,
                      c_split: int = 1) -> torch.Tensor:
    """Pool N = n_images * n_per boxes -> (N, R, R, C) from per-level
    buffers, image by image and C-block by C-block.

    ``fmaps_padded`` as for :func:`roi_pool_patches`; image b of level l
    occupies rows [b*(H_l+patch), (b+1)*(H_l+patch)).  ``meta`` (N, 3) int32
    [level, row0, col0] with row0 IMAGE-RELATIVE and both origins clamped to
    [0, sec_h-patch] x [0, sec_w-patch-8], where (sec_h, sec_w) =
    (max(H_l, patch), max(W_l, patch+8)) is the unpadded corner of the
    section, and the hat matrices shifted to match.  Box i belongs to image
    i // n_per; n_per is a multiple of ``chunk`` (the boxes one block
    serves), which the caller reaches by padding each image's boxes with
    zero hats and ``meta`` 0.  ``c_split`` blocks of C / c_split channels
    bound the per-image working set (:func:`resident_section_bytes`).

    On the card, float32 features take ``pool_box`` and bfloat16 features
    ``pool_box_bf16``, as in :func:`roi_pool_patches`; in bfloat16 each
    C-block must also be a whole number of 32-channel slices.  Other
    bfloat16 inputs raise.
    """
    _check_resident(fmaps_padded, meta, ay, ax, resolution, patch, chunk,
                    n_images, c_split)
    first = fmaps_padded[0]
    if first.device.type == "cpu":
        return roi_pool_resident_reference(fmaps_padded, meta, ay, ax,
                                           resolution, patch, chunk, n_images,
                                           c_split)
    _check_cuda(first, resolution)
    n, c = meta.shape[0], first.shape[-1]
    if first.dtype == torch.bfloat16:
        _check_bf16_kernel(fmaps_padded, patch)
        if (c // c_split) % 32:
            raise ValueError(f"the bfloat16 kernel needs C-blocks of a "
                             f"multiple of 32 channels; got C={c}, "
                             f"c_split={c_split}")
    out = torch.empty((n, resolution, resolution, c), dtype=first.dtype,
                      device=first.device)
    if n == 0:
        return out
    fn = _get_fn("roi_pool_resident")
    bases, rows, widths = _level_arrays(fmaps_padded)
    with torch.cuda.device(first.device):
        stream = torch.cuda.current_stream(first.device).cuda_stream
        rc = fn(bases, rows, widths, len(fmaps_padded), meta.data_ptr(),
                ay.data_ptr(), ax.data_ptr(), out.data_ptr(), n_images,
                n // n_images, chunk, c_split, resolution, patch, c,
                _DTYPE_CODE[first.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"td_roi_pool_resident failed with CUDA error {rc}")
    _count("launches_resident")
    return out


def roi_pool_resident_reference(fmaps_padded: Sequence[torch.Tensor],
                                meta: torch.Tensor, ay: torch.Tensor,
                                ax: torch.Tensor, resolution: int, patch: int,
                                chunk: int, n_images: int,
                                c_split: int = 1) -> torch.Tensor:
    """Plain PyTorch version of K6: the image's row base is added to the
    image-relative origins, and each C-block is pooled on its own from the
    same cells the kernel reads (``chunk`` only shapes the kernel's grid)."""
    first = fmaps_padded[0]
    n, c = meta.shape[0], first.shape[-1]
    out = torch.zeros((n, resolution, resolution, c), dtype=first.dtype,
                      device=first.device)
    src_hs, _, _ = resident_geometry(fmaps_padded, n_images, patch)
    m = meta.long()
    image = torch.arange(n, device=meta.device) // max(n // n_images, 1)
    rows = image * torch.tensor(src_hs, device=meta.device)[m[:, 0]] + m[:, 1]
    c_blk = c // c_split
    for cb in range(c_split):
        _pool_windows(fmaps_padded, m[:, 0], rows, m[:, 2], ay, ax, out,
                      patch, channels=slice(cb * c_blk, (cb + 1) * c_blk))
    return out


# --- the batched pooler's geometry and exact tail -----------------------------

def _check_table(table: torch.Tensor, device: torch.device) -> None:
    if (table.dtype != torch.int64 or table.dim() != 2
            or table.shape[1] != len(TABLE_COLUMNS)
            or not 1 <= table.shape[0] <= MAX_LEVELS
            or not table.is_contiguous() or table.device != device):
        raise ValueError(f"the level table must be a contiguous int64 (L, "
                         f"{len(TABLE_COLUMNS)}) tensor with 1 <= L <= "
                         f"{MAX_LEVELS} on {device}, got {table.dtype} "
                         f"{tuple(table.shape)} on {table.device}")


def roi_geometry(boxes: torch.Tensor, table: torch.Tensor, n_per_image: int,
                 resolution: int, sampling_ratio: int, patch: int,
                 flat: bool):
    """Every box's patch geometry on the card, one launch for all boxes.

    ``boxes`` (N, 4) float32 CUDA, image i // ``n_per_image`` each;
    ``table`` the (L, 9) int64 level table (``TABLE_COLUMNS``).  Returns,
    in this order: img, levels, oy, ox_al (N,) int64; sy, sx_al (N, R*S)
    float32; valid_y, valid_x (N, R*S) bool; ay (N, R, patch) and ax
    (N, R, patch+8) float32; overflow (N,) bool; prio (N,) float32 (2 where
    the box overflows, else 0); and the window index: with ``flat`` K1's
    (2, N) int32 [rows; cols], else K5's (N, 3) int32 meta.  Raises for a
    tensor that is not on the card: the plain version is
    ``ops.roi_align._box_geometry``."""
    dev = boxes.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if (boxes.dtype != torch.float32 or boxes.dim() != 2
            or boxes.shape[1] != 4 or not boxes.is_contiguous()):
        raise ValueError(f"boxes must be contiguous float32 (N, 4), got "
                         f"{boxes.dtype} {tuple(boxes.shape)}")
    _check_table(table, dev)
    n = boxes.shape[0]
    if n_per_image < 1 or n % n_per_image or sampling_ratio < 1 \
            or resolution < 1 or patch < 1:
        raise ValueError(f"{n} boxes in images of {n_per_image}, resolution "
                         f"{resolution}, sampling ratio {sampling_ratio}, "
                         f"patch {patch}")
    rs = resolution * sampling_ratio

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = (empty(n, torch.int64), empty(n, torch.int64),
           empty(n, torch.int64), empty(n, torch.int64),
           empty((n, rs), torch.float32), empty((n, rs), torch.float32),
           empty((n, rs), torch.bool), empty((n, rs), torch.bool),
           empty((n, resolution, patch), torch.float32),
           empty((n, resolution, patch + 8), torch.float32),
           empty(n, torch.bool), empty(n, torch.float32),
           empty((2, n) if flat else (n, 3), torch.int32))
    if n == 0:
        return out
    fn = _get_fn("roi_pool_prep", "td_roi_geometry")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(boxes.data_ptr(), table.data_ptr(), table.shape[0], n,
                n_per_image, resolution, sampling_ratio, patch, int(flat),
                *[t.data_ptr() for t in out], stream)
    if rc != 0:
        raise RuntimeError(f"td_roi_geometry failed with CUDA error {rc}")
    _count("launches_geometry")
    return out


def roi_exact_tail(buffers: Sequence[torch.Tensor], flat: bool,
                   table: torch.Tensor, boxes: torch.Tensor,
                   flag: torch.Tensor, idx: torch.Tensor, out: torch.Tensor,
                   sel, resolution: int, sampling_ratio: int) -> None:
    """Pool exactly, on the card, the boxes a per-image top-k picked, into
    ``out`` in place.

    Box ``b * N + idx[b, j]`` (N = boxes per image) is pooled where
    ``flag[b, j] > 0``: its (R, R, C) row of ``out`` (B*N, R, R, C) is
    overwritten and ``sel[box]`` (a (B*N,) bool tensor, or None) set; other
    rows are left alone.  ``idx`` (B, m) int64 and ``flag`` (B, m) float32
    need unit stride along m only (a top-k's slices, or an expanded
    ``arange`` for every box).  ``buffers``: K1's buffer with ``flat``,
    else the per-level buffers of K5 and K6; ``table`` the level table;
    ``boxes`` (B*N, 4) float32 (each box's level is found again, as the
    geometry found it).  Raises for a tensor that is not on the card: the plain
    version is ``ops.roi_align._exact_tail_reference``."""
    first = buffers[0]
    dev = first.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if first.dtype not in _DTYPE_CODE:
        raise TypeError(f"features must be float32 or bfloat16, got "
                        f"{first.dtype}")
    if not 1 <= len(buffers) <= MAX_LEVELS or (flat and len(buffers) != 1):
        raise ValueError(f"{len(buffers)} feature buffers")
    c = first.shape[-1]
    for f in buffers:
        if (f.dim() != 3 or f.dtype != first.dtype or f.shape[-1] != c
                or not f.is_contiguous() or f.device != dev):
            raise ValueError("feature buffers must be contiguous (rows, W, "
                             "C) tensors of one dtype, C and device")
    _check_table(table, dev)
    if not flat and len(buffers) != table.shape[0]:
        raise ValueError(f"{len(buffers)} level buffers for "
                         f"{table.shape[0]} levels")
    b, m = idx.shape
    n_boxes = boxes.shape[0]
    checks = [(boxes, torch.float32, (n_boxes, 4)),
              (out, first.dtype, (n_boxes, resolution, resolution, c))]
    if sel is not None:
        checks.append((sel, torch.bool, (n_boxes,)))
    for t, dtype, shape in checks:
        if (t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"expected a contiguous {dtype} {shape} tensor "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    for t, dtype in ((idx, torch.int64), (flag, torch.float32)):
        if (t.dtype != dtype or tuple(t.shape) != (b, m) or t.device != dev
                or (m > 1 and t.stride(1) != 1)):
            raise ValueError(f"idx and flag must be int64 and float32 (B, m) "
                             f"with unit stride along m, got {t.dtype} "
                             f"{tuple(t.shape)} {t.stride()}")
    if b < 1 or n_boxes % b or sampling_ratio < 1 or resolution < 1:
        raise ValueError(f"{n_boxes} boxes in {b} images, resolution "
                         f"{resolution}, sampling ratio {sampling_ratio}")
    if b * m == 0:
        return
    fn = _get_fn("roi_pool_prep", "td_roi_exact_tail")
    ptrs = (ctypes.c_void_p * MAX_LEVELS)(
        *[f.data_ptr() for f in buffers],
        *[None] * (MAX_LEVELS - len(buffers)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ptrs, table.data_ptr(), table.shape[0], int(flat),
                boxes.data_ptr(), idx.data_ptr(),
                idx.stride(0), flag.data_ptr(), flag.stride(0), b, m,
                n_boxes // b, resolution, sampling_ratio, c,
                _DTYPE_CODE[first.dtype], out.data_ptr(),
                0 if sel is None else sel.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"td_roi_exact_tail failed with CUDA error {rc}")
    _count("launches_exact_tail")
