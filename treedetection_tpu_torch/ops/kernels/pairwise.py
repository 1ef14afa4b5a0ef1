"""K2, K3, K4 — the pairwise box relations: CUDA kernels, wrappers, plain
versions.

Replaces ``pairwise_dedupe_mask`` (K2), ``pairwise_containment_mask`` (K3) and
``pairwise_iou_mask`` (K4) of ``treedetection_tpu/ops/pallas/iou_kernel.py``
with the same contracts.  For row boxes ``rows`` (R, 4) (default: ``boxes``,
the square case) and column boxes ``boxes`` (N, 4), float32 ``[x0, y0, x1,
y1]``, each returns an (R, N) uint8 mask:

* :func:`pairwise_iou_mask` — ``IoU(row_i, box_j) > threshold`` (0 where the
  union is 0);
* :func:`pairwise_containment_mask` — ``inter(row_i, box_j) / area(box_j) >=
  threshold`` (0 where the area is 0); in the square case the diagonal is
  cleared;
* :func:`pairwise_dedupe_mask` — ``IoU > iou_threshold`` AND ``|pa_i - pa_j| /
  max(pa_i, pa_j, 1e-9) < area_threshold`` on the polygon areas.

K2 and K3 also come bit-packed, which is what the crown filter streams:
:func:`pairwise_dedupe_bits` and :func:`pairwise_containment_bits` return the
same relation as (R, ceil(N/8)) uint8 in numpy's ``packbits`` order
(:func:`pack_bits_rows` of the mask), and :func:`relation_pairs` compacts
such a block on the card to its (i, j) pairs in ``np.nonzero``'s order.

The CUDA source is ``csrc/pairwise_boxes.cu``, compiled with nvcc for
``sm_90a`` at first use and bound with ctypes: one relation kernel for K2,
K3 and K4 (K2 and K3 in both forms, K4 as the uint8 mask), and the two
compaction kernels.  Rounding
decides a threshold test, so the source is built with ``-fmad=false`` and
keeps the plain versions' order of operations; the relations are then equal
bit for bit, which is what ``chip_smoke.py`` and the card tests check.  For a
CUDA tensor a wrapper launches its kernel or raises; only tensors on the CPU
take the plain versions (``*_reference``).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from treedetection_tpu_torch.build import build_shared_library, nvcc_path
from treedetection_tpu_torch.ops.boxes import (
    box_iou_matrix, pairwise_intersection_over_area)

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "pairwise_boxes.cu"
# -fmad=false: no FMA contraction, so every operation rounds as the plain
# version's separate elementwise operations do (never -use_fast_math)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_MODE = {"iou": 0, "containment": 1, "dedupe": 2}

# kernel launches since the last reset, per mode (plain counts;
# chip_smoke.py reads them to show the main path went through the kernel;
# "dedupe" and "containment" count the relation kernel in either form, one
# per call, and "pairs" one per relation_pairs call that compacts on the card)
launches: Dict[str, int] = {"iou": 0, "containment": 0, "dedupe": 0,
                            "pairs": 0}

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_ARG_TYPES = {
    "td_pairwise_boxes": [_P, _P, _P, _I, _I, _I, _F, _F, _P],
    "td_pairwise_relation_bits": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _P],
    "td_relation_row_counts": [_P, _L, _I, _I, _I, _I, _P, _P],
    "td_relation_pairs": [_P, _L, _I, _I, _I, _I, _P, _P, _P, _P],
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def build() -> Path:
    """Compile (or find) the kernel library; returns its path.  The
    compiler's output (``-Xptxas -v``) is kept beside it as ``<name>.log``."""
    return build_shared_library("pairwise_boxes", [_SRC],
                                [nvcc_path()] + NVCC_FLAGS)


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build()))
                for name, argtypes in _ARG_TYPES.items():
                    fn = getattr(lib, name)
                    fn.restype = ctypes.c_int
                    fn.argtypes = argtypes
                _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, width: int,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != 2 or t.shape[1] != width:
        raise ValueError(f"{name} must be (n, {width}), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _on_one_card(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.device != b.device:
        raise ValueError(f"rows are on {a.device}, boxes on {b.device}")
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUDA error {rc}")


def _launch_into(mode: str, a: torch.Tensor, b: torch.Tensor,
                 out: torch.Tensor, t0: float, t1: float, packed: bool,
                 clear_diagonal: bool = False) -> None:
    """Launch the relation of a's rows against b's rows (R, N > 0, one card)
    into ``out``: with ``packed`` the (R, pitch) bit-packed block
    (``_bits_pitch``; column i of row i cleared with ``clear_diagonal``),
    else the (R, N) uint8 mask.  The wrappers' one launcher."""
    lib = _get_lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0],
                b.shape[0])
        if packed:
            entry = "td_pairwise_relation_bits"
            rc = lib.td_pairwise_relation_bits(
                *args, out.stride(0), _MODE[mode], float(t0), float(t1),
                int(clear_diagonal), stream)
        else:
            entry = "td_pairwise_boxes"
            rc = lib.td_pairwise_boxes(*args, _MODE[mode], float(t0),
                                       float(t1), stream)
    _raise_on(rc, f"{entry}({mode})")
    launches[mode] += 1


def _launch(mode: str, a: torch.Tensor, b: torch.Tensor, t0: float,
            t1: float) -> torch.Tensor:
    """(R, N) uint8 relation of a's rows against b's rows on the card."""
    _on_one_card(a, b)
    out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.uint8,
                      device=a.device)
    if out.numel():
        _launch_into(mode, a, b, out, t0, t1, packed=False)
    return out


def _bits_pitch(n_cols: int) -> int:
    """Row pitch in bytes of the kernel's bit-packed block: ceil(N/8) rounded
    up to 16, so that every lane stores whole 16-byte chunks."""
    return -(-((n_cols + 7) // 8) // 16) * 16


def _launch_bits(mode: str, a: torch.Tensor, b: torch.Tensor, t0: float,
                 t1: float, clear_diagonal: bool) -> torch.Tensor:
    """(R, ceil(N/8)) bit-packed relation on the card: a view of the
    kernel's (R, pitch) block."""
    _on_one_card(a, b)
    r, n = a.shape[0], b.shape[0]
    nbytes = (n + 7) // 8
    if r == 0 or n == 0:
        return torch.empty((r, nbytes), dtype=torch.uint8, device=a.device)
    out = torch.empty((r, _bits_pitch(n)), dtype=torch.uint8, device=a.device)
    _launch_into(mode, a, b, out, t0, t1, packed=True,
                 clear_diagonal=clear_diagonal)
    return out[:, :nbytes]


def _f32(value: float, device: torch.device) -> torch.Tensor:
    """A threshold as a float32 scalar: the comparison is made in float32,
    as the kernel makes it."""
    return torch.tensor(float(value), dtype=torch.float32, device=device)


# --- plain versions ----------------------------------------------------------

def iou_mask_reference(a: torch.Tensor, b: torch.Tensor,
                       threshold: float) -> torch.Tensor:
    return (box_iou_matrix(a, b) > _f32(threshold, a.device)).to(torch.uint8)


def containment_mask_reference(a: torch.Tensor, b: torch.Tensor,
                               threshold: float) -> torch.Tensor:
    """contains[i, j] = inter(a_i, b_j) / area(b_j) >= threshold (no
    diagonal rule)."""
    # ratios[j, i] = inter / area_j -> transpose for contains[i, j]
    ratio = pairwise_intersection_over_area(b, a).T
    return (ratio >= _f32(threshold, a.device)).to(torch.uint8)


def dedupe_mask_reference(a5: torch.Tensor, b5: torch.Tensor,
                          iou_threshold: float,
                          area_threshold: float) -> torch.Tensor:
    iou = box_iou_matrix(a5[:, :4], b5[:, :4])
    pa = a5[:, 4][:, None]
    pb = b5[:, 4][None, :]
    rel = (pa - pb).abs() / torch.clamp(torch.maximum(pa, pb), min=1e-9)
    return ((iou > _f32(iou_threshold, a5.device))
            & (rel < _f32(area_threshold, a5.device))).to(torch.uint8)


def pack_bits_rows(m: torch.Tensor) -> torch.Tensor:
    """(R, N) 0/1 uint8 -> (R, ceil(N/8)) uint8, MSB-first (numpy
    ``packbits`` order); the last byte is zero-filled when N % 8 != 0.  The
    plain version of the bit-packed wrappers."""
    r, nn = m.shape
    if nn % 8:
        m = torch.nn.functional.pad(m, (0, 8 - nn % 8))
    lanes = m.reshape(r, m.shape[1] // 8, 8)
    out = lanes[..., 0] << 7
    for k in range(1, 8):
        out = out | (lanes[..., k] << (7 - k))
    return out


def relation_pairs_reference(bits: torch.Tensor, n_cols: int,
                             row_offset: int = 0,
                             drop_diagonal: bool = True) -> torch.Tensor:
    """(2, P) int32 pairs of a bit-packed block: ``torch.nonzero`` of the
    unpacked (R, n_cols) relation, rows shifted by ``row_offset``, and the
    pairs with i == j left out when ``drop_diagonal``."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=bits.device)
    m = ((bits[..., None] >> shifts) & 1).reshape(bits.shape[0],
                                                  8 * bits.shape[1])
    ii, jj = torch.nonzero(m[:, :n_cols], as_tuple=True)
    ii = ii + row_offset
    if drop_diagonal:
        keep = ii != jj
        ii, jj = ii[keep], jj[keep]
    return torch.stack([ii, jj]).to(torch.int32)


# --- wrappers ----------------------------------------------------------------

def pairwise_iou_mask(boxes: torch.Tensor, threshold: float,
                      rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(R, N) uint8 mask of IoU(row_i, box_j) > threshold; ``rows`` defaults
    to ``boxes`` (the square case)."""
    a = boxes if rows is None else rows
    _check("boxes", boxes, 4, boxes.device)
    _check("rows", a, 4, boxes.device)
    if boxes.device.type == "cpu":
        return iou_mask_reference(a, boxes, threshold)
    return _launch("iou", a, boxes, threshold, 0.0)


def _containment_rows(boxes: torch.Tensor,
                      rows: Optional[torch.Tensor]) -> torch.Tensor:
    a = boxes if rows is None else rows
    _check("boxes", boxes, 4, boxes.device)
    _check("rows", a, 4, boxes.device)
    return a


def _containment_mask_cpu(a: torch.Tensor, boxes: torch.Tensor,
                          threshold: float, square: bool) -> torch.Tensor:
    out = containment_mask_reference(a, boxes, threshold)
    return out.fill_diagonal_(0) if square else out


def pairwise_containment_mask(boxes: torch.Tensor, threshold: float,
                              rows: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """(R, N) uint8: row_i contains box_j (intersection/area_j >= threshold);
    for the square case the diagonal is cleared."""
    a = _containment_rows(boxes, rows)
    if boxes.device.type == "cpu":
        return _containment_mask_cpu(a, boxes, threshold, rows is None)
    out = _launch("containment", a, boxes, threshold, 0.0)
    return out.fill_diagonal_(0) if rows is None else out


def pairwise_containment_bits(boxes: torch.Tensor, threshold: float,
                              rows: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """:func:`pairwise_containment_mask` bit-packed: (R, ceil(N/8)) uint8 in
    numpy's ``packbits`` order, zero past N."""
    a = _containment_rows(boxes, rows)
    if boxes.device.type == "cpu":
        return pack_bits_rows(
            _containment_mask_cpu(a, boxes, threshold, rows is None))
    return _launch_bits("containment", a, boxes, threshold, 0.0,
                        clear_diagonal=rows is None)


def _dedupe_operands(boxes: torch.Tensor, areas: torch.Tensor,
                     rows: Optional[torch.Tensor],
                     row_areas: Optional[torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (a5, b5): row and column boxes with their polygon area as a 5th
    column."""
    _check("boxes", boxes, 4, boxes.device)
    _check("areas", areas.reshape(-1, 1) if areas.dim() == 1 else areas, 1,
           boxes.device)
    if areas.shape[0] != boxes.shape[0]:
        raise ValueError(f"{boxes.shape[0]} boxes but {areas.shape[0]} areas")
    b5 = torch.cat([boxes, areas.reshape(-1, 1)], dim=1)
    if rows is None:
        return b5, b5
    if row_areas is None:
        raise ValueError("rows given without row_areas")
    _check("rows", rows, 4, boxes.device)
    _check("row_areas", row_areas.reshape(-1, 1)
           if row_areas.dim() == 1 else row_areas, 1, boxes.device)
    if row_areas.shape[0] != rows.shape[0]:
        raise ValueError(
            f"{rows.shape[0]} rows but {row_areas.shape[0]} row_areas")
    return torch.cat([rows, row_areas.reshape(-1, 1)], dim=1), b5


def pairwise_dedupe_mask(boxes: torch.Tensor, areas: torch.Tensor,
                         iou_threshold: float, area_threshold: float = 0.3,
                         rows: Optional[torch.Tensor] = None,
                         row_areas: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """(R, N) uint8 dedupe relation: bbox IoU > iou_threshold AND relative
    polygon-area difference < area_threshold."""
    a5, b5 = _dedupe_operands(boxes, areas, rows, row_areas)
    if boxes.device.type == "cpu":
        return dedupe_mask_reference(a5, b5, iou_threshold, area_threshold)
    return _launch("dedupe", a5, b5, iou_threshold, area_threshold)


def pairwise_dedupe_bits(boxes: torch.Tensor, areas: torch.Tensor,
                         iou_threshold: float, area_threshold: float = 0.3,
                         rows: Optional[torch.Tensor] = None,
                         row_areas: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """:func:`pairwise_dedupe_mask` bit-packed: (R, ceil(N/8)) uint8 in
    numpy's ``packbits`` order, zero past N."""
    a5, b5 = _dedupe_operands(boxes, areas, rows, row_areas)
    if boxes.device.type == "cpu":
        return pack_bits_rows(
            dedupe_mask_reference(a5, b5, iou_threshold, area_threshold))
    return _launch_bits("dedupe", a5, b5, iou_threshold, area_threshold,
                        clear_diagonal=False)


def _check_word_readable(bits: torch.Tensor, n_cols: int) -> None:
    """The compaction kernels read each row's ceil(N/32) 4-byte words in
    place: rows 4-byte aligned, their pitch a multiple of 4, the last word
    inside the storage.  The bit-packed wrappers' blocks are (16-byte
    pitch); a tight (R, ceil(N/8)) copy with ceil(N/8) % 4 != 0 is not."""
    r, stride = bits.shape[0], bits.stride(0)
    need = 4 * ((n_cols + 31) // 32)
    room = bits.untyped_storage().nbytes() - bits.storage_offset()
    if not (bits.stride(1) == 1 and stride % 4 == 0 and stride >= need
            and bits.data_ptr() % 4 == 0
            and room >= (r - 1) * stride + need):
        raise ValueError(
            f"bits rows cannot be read as 4-byte words in place (row pitch "
            f"{stride} bytes, {need} needed per row): pass the bit-packed "
            f"wrappers' block or one with a row pitch of _bits_pitch(n_cols)")


def _pair_ends_into(bits: torch.Tensor, n_cols: int, row_offset: int,
                    drop_diagonal: bool, counts: torch.Tensor,
                    ends: torch.Tensor) -> None:
    """Launch the count kernel into ``counts`` (R int64), then scan them into
    ``ends`` (the inclusive scan: row i's pairs end at ends[i])."""
    lib = _get_lib()
    with torch.cuda.device(bits.device):
        stream = torch.cuda.current_stream(bits.device).cuda_stream
        _raise_on(lib.td_relation_row_counts(
            bits.data_ptr(), bits.stride(0), bits.shape[0], n_cols,
            int(row_offset), int(drop_diagonal), counts.data_ptr(), stream),
            "td_relation_row_counts")
        launches["pairs"] += 1
        torch.cumsum(counts, 0, out=ends)


def _pairs_into(bits: torch.Tensor, n_cols: int, row_offset: int,
                drop_diagonal: bool, ends: torch.Tensor,
                out: torch.Tensor) -> None:
    """Launch the pairs kernel: row i's pairs into out[:, ends[i-1]:ends[i]]
    of the (2, ends[-1]) int32 ``out``."""
    lib = _get_lib()
    with torch.cuda.device(bits.device):
        stream = torch.cuda.current_stream(bits.device).cuda_stream
        _raise_on(lib.td_relation_pairs(
            bits.data_ptr(), bits.stride(0), bits.shape[0], n_cols,
            int(row_offset), int(drop_diagonal), ends.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), stream),
            "td_relation_pairs")


def relation_pairs(bits: torch.Tensor, n_cols: int, row_offset: int = 0,
                   drop_diagonal: bool = True) -> torch.Tensor:
    """(2, P) int32 pairs ``(row_offset + i, j)`` of a bit-packed (R,
    ceil(n_cols/8)) relation block, in row-major order (``np.nonzero``'s);
    with ``drop_diagonal`` the pairs with ``j == row_offset + i`` are left
    out.  On the card: a warp per row counts its pairs, the counts are
    scanned, the total is read back once to size the output, and a warp per
    row with pairs writes them.  A card block's rows must be readable as
    4-byte words in place, as the bit-packed wrappers' are."""
    if not isinstance(bits, torch.Tensor) or bits.dtype != torch.uint8 \
            or bits.dim() != 2:
        raise TypeError("bits must be a 2-D uint8 torch.Tensor")
    if bits.shape[1] != (n_cols + 7) // 8:
        raise ValueError(f"bits has {bits.shape[1]} bytes per row, "
                         f"{n_cols} columns need {(n_cols + 7) // 8}")
    r = bits.shape[0]
    if row_offset < 0 or row_offset + r >= 2 ** 31 or n_cols >= 2 ** 31:
        raise ValueError(f"row_offset {row_offset} or n_cols {n_cols} out of "
                         f"int32 range")
    if bits.device.type == "cpu":
        return relation_pairs_reference(bits, n_cols, row_offset,
                                        drop_diagonal)
    if bits.device.type != "cuda":
        raise ValueError(f"unsupported device {bits.device}")
    if r == 0 or n_cols == 0:
        return torch.empty((2, 0), dtype=torch.int32, device=bits.device)
    _check_word_readable(bits, n_cols)
    counts = torch.empty(r, dtype=torch.int64, device=bits.device)
    ends = torch.empty_like(counts)
    _pair_ends_into(bits, n_cols, row_offset, drop_diagonal, counts, ends)
    out = torch.empty((2, int(ends[-1])), dtype=torch.int32,
                      device=bits.device)
    if out.shape[1]:
        _pairs_into(bits, n_cols, row_offset, drop_diagonal, ends, out)
    return out
