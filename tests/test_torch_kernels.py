"""K1, K5, K6 (the flat, per-level and image-resident ROIAlign patch poolers)
and K2/K3/K4 (the pairwise box-relation masks) on the card against their
plain versions.

These tests need an NVIDIA GPU: they carry the ``gpu`` marker and skip
elsewhere.  On the card: ``python -m pytest tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from treedetection_tpu_torch.ops.kernels import pairwise as k234
from treedetection_tpu_torch.ops.kernels import roi_align as k1
from treedetection_tpu_torch.ops.roi_align import (
    flat_pool_inputs, level_pool_inputs, resident_pool_inputs)

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(dev, dtype, resolution, b=2, n=64, c=64, seed=0,
            prep=flat_pool_inputs):
    rng = np.random.default_rng(seed)
    fmaps = [torch.from_numpy(rng.standard_normal(
        (b, 128 >> i, 128 >> i, c)).astype(np.float32)).to(dev, dtype)
        for i in range(4)]
    ctr = rng.uniform(0, 512, (b, n, 2))
    wh = rng.uniform(8, 200, (b, n, 2))
    boxes = np.clip(np.concatenate([ctr - wh / 2, ctr + wh / 2], -1), 0, 512)
    boxes = torch.from_numpy(boxes.astype(np.float32)).to(dev)
    return prep(fmaps, boxes, resolution, (4, 8, 16, 32))


def _assert_close(got, ref, dtype):
    """float32: summation order only, atol 2e-5 of the peak.  bfloat16: both
    round the hats and t to bf16 and accumulate in float32 in different
    orders, so one bf16 ulp of the output (2^-7 relative) plus 2^-8 of the
    peak for a t rounding that the order flips (chip_smoke.tolerance)."""
    ref = ref.float()
    peak = max(1.0, float(ref.abs().max())) if ref.numel() else 1.0
    if dtype == torch.float32:
        atol, rtol = 2e-5 * peak, 0.0
    else:
        atol, rtol = 2.0 ** -8 * peak, 2.0 ** -7
    assert got.shape == ref.shape
    assert ((got.float() - ref).abs() <= atol + rtol * ref.abs()).all()


@pytest.mark.parametrize("resolution", [7, 14])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_matches_plain_version(cuda, resolution, dtype):
    """float32 (pool_box): summation order only, atol 2e-5 of the peak.
    bfloat16 (the tensor-core kernel): one bf16 ulp (2^-7 relative) plus
    2^-8 of the peak for a flipped rounding of t."""
    p = _inputs(cuda, dtype, resolution)
    args = (p.kcat, p.rows, p.cols, p.ay, p.ax, resolution)
    before = k1.launches
    got = k1.roi_pool_patches_flat(*args)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    _assert_close(got, k1.roi_pool_patches_flat_reference(*args), dtype)


def test_k1_raises_instead_of_falling_back(cuda):
    p = _inputs(cuda, torch.float32, 7, n=8)
    with pytest.raises(ValueError, match="resolutions"):
        k1.roi_pool_patches_flat(p.kcat, p.rows, p.cols,
                                 p.ay[:, :5].contiguous(),
                                 p.ax[:, :5].contiguous(), 5)
    with pytest.raises(ValueError, match="is on cpu"):
        k1.roi_pool_patches_flat(p.kcat, p.rows.cpu(), p.cols, p.ay, p.ax, 7)
    # C not a multiple of 8 and a misaligned buffer: the bf16 kernel raises
    before = k1.launches
    f = torch.zeros((100, 64, 12), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        k1.roi_pool_patches_flat(f, p.rows.clamp(max=50), p.cols.clamp(max=8),
                                 p.ay, p.ax, 7)
    g = torch.zeros(100 * 64 * 8 + 1, dtype=torch.bfloat16,
                    device=cuda)[1:].view(100, 64, 8)
    with pytest.raises(ValueError, match="aligned"):
        k1.roi_pool_patches_flat(g, p.rows.clamp(max=50), p.cols.clamp(max=8),
                                 p.ay, p.ax, 7)
    assert k1.launches == before


# name -> (hat rows kept, hat columns kept, boxes with all-zero hats): the
# spans the bf16 kernel must handle, on dense random hats at C = 256
SPAN_CASES = {
    "full_48x56": (slice(0, 48), slice(0, 56), ()),
    "one_row": (slice(20, 21), slice(3, 40), ()),
    "row_47_col_55": (slice(33, 48), slice(41, 56), ()),
    "one_cell_at_47_55": (slice(47, 48), slice(55, 56), ()),
    "some_all_zero": (slice(5, 30), slice(0, 20), (0, 7, 36)),
    "all_zero": (slice(0, 0), slice(0, 0), ()),
}


def _span_hats(rng, case, resolution, n, dead, patch=48):
    """float32 hats (n, R, patch) and (n, R, patch + 8), random on the
    case's span and zero elsewhere; ``ay`` all zero for the boxes ``dead``.
    """
    rows_kept, cols_kept, _ = SPAN_CASES[case]
    ay = np.zeros((n, resolution, patch), dtype=np.float32)
    ax = np.zeros((n, resolution, patch + 8), dtype=np.float32)
    ay[:, :, rows_kept] = rng.uniform(0.01, 0.5, ay[:, :, rows_kept].shape)
    ax[:, :, cols_kept] = rng.uniform(0.01, 0.5, ax[:, :, cols_kept].shape)
    ay[list(dead)] = 0.0
    return ay, ax


def _stacked(bufs):
    """K1's buffer of the same cells: ``bufs`` stacked into one, zero-padded
    to the widest; and the first row of each."""
    wmax = max(f.shape[1] for f in bufs)
    fcat = bufs[0].new_zeros((sum(f.shape[0] for f in bufs), wmax,
                              bufs[0].shape[-1]))
    base = np.cumsum([0] + [f.shape[0] for f in bufs])[:-1]
    for b0, f in zip(base, bufs):
        fcat[b0:b0 + f.shape[0], :f.shape[1]] = f
    return fcat, base


@pytest.mark.parametrize("n", [0, 37])
@pytest.mark.parametrize("case", sorted(SPAN_CASES))
@pytest.mark.parametrize("resolution", [7, 14])
def test_k1_bf16_spans(cuda, resolution, case, n):
    """The bf16 kernel (hats' span only, cp.async staging, mma.sync) against
    the plain version on hats cut to one span, at C = 256, N = 37 (a
    multiple of nothing the kernel tiles by) and N = 0.  Boxes whose hats are
    all zero pool to exact zeros; N = 0 launches nothing."""
    zero = [i for i in SPAN_CASES[case][2] if i < n]
    rng = np.random.default_rng(resolution * 100 + n)
    c, patch = 256, 48
    fcat = torch.from_numpy(rng.standard_normal((200, 120, c)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    rows = torch.from_numpy(rng.integers(0, 200 - patch, n).astype(np.int32))
    cols = torch.from_numpy((rng.integers(0, 8, n) * 8).astype(np.int32))
    ay, ax = _span_hats(rng, case, resolution, n, zero)
    args = (fcat, rows.to(cuda), cols.to(cuda), torch.from_numpy(ay).to(cuda),
            torch.from_numpy(ax).to(cuda), resolution)
    before = k1.launches
    got = k1.roi_pool_patches_flat(*args)
    torch.cuda.synchronize()
    assert k1.launches == before + (1 if n else 0)
    assert got.shape == (n, resolution, resolution, c)
    ref = k1.roi_pool_patches_flat_reference(*args)
    _assert_close(got, ref, torch.bfloat16)
    for i in (zero if case != "all_zero" else range(n)):
        assert float(got[i].float().abs().max()) == 0.0
    if n and case != "all_zero":
        assert float(ref.float().abs().max()) > 0.1


# (rows, width) of the four level buffers of the K5 span cases: widths 56
# above a multiple of 8, so that a window can end on a buffer's last column
LEVEL_SHAPES = ((200, 120), (136, 88), (104, 72), (96, 64))


def _level_span_inputs(dev, resolution, case, n):
    """K5's inputs for one of SPAN_CASES: four bf16 level buffers at C = 256
    with dense random features, boxes on every level (the first four at
    each level's bottom-right corner: the window ends on the buffer's last
    row and column), random hats cut to the case's span; and K1's inputs on
    the same cells: the buffers stacked into one, zero-padded to the widest.
    """
    rng = np.random.default_rng(resolution * 100 + n + 1)
    c, patch = 256, 48
    bufs = [torch.from_numpy(rng.standard_normal((h, w, c)).astype(
        np.float32)).to(dev, torch.bfloat16) for h, w in LEVEL_SHAPES]
    max_row = np.array([h - patch for h, _ in LEVEL_SHAPES])
    max_col = np.array([w - patch - 8 for _, w in LEVEL_SHAPES])
    level = rng.integers(0, 4, n)
    level[:4] = np.arange(min(n, 4))
    row = rng.integers(0, max_row[level] + 1)
    col = rng.integers(0, max_col[level] // 8 + 1) * 8
    row[:4], col[:4] = max_row[level[:4]], max_col[level[:4]]
    meta = np.stack([level, row, col], axis=1).astype(np.int32)
    ay, ax = _span_hats(rng, case, resolution, n,
                        [i for i in SPAN_CASES[case][2] if i < n])
    ay, ax = torch.from_numpy(ay).to(dev), torch.from_numpy(ax).to(dev)
    fcat, base = _stacked(bufs)
    k5 = (tuple(bufs), torch.from_numpy(meta).to(dev), ay, ax, resolution)
    k1 = (fcat, torch.from_numpy((base[level] + row).astype(np.int32)).to(dev),
          torch.from_numpy(col.astype(np.int32)).to(dev), ay, ax, resolution)
    return k5, k1


@pytest.mark.parametrize("n", [0, 37])
@pytest.mark.parametrize("case", sorted(SPAN_CASES))
@pytest.mark.parametrize("resolution", [7, 14])
def test_k5_bf16_spans(cuda, resolution, case, n):
    """K5's bf16 kernel (K1's pool_box_bf16 on the box's level buffer)
    against its plain version on K1's span cases, boxes on every level and
    windows on each buffer's last row and column, at C = 256, N = 37 and
    N = 0 (no launch); and EQUAL to K1 on the same cells."""
    _, _, zero = SPAN_CASES[case]
    k5_args, k1_args = _level_span_inputs(cuda, resolution, case, n)
    before = (k1.launches, k1.launches_patches)
    got = k1.roi_pool_patches(*k5_args)
    torch.cuda.synchronize()
    assert (k1.launches, k1.launches_patches) == (before[0],
                                                  before[1] + (1 if n else 0))
    assert got.shape == (n, resolution, resolution, 256)
    ref = k1.roi_pool_patches_reference(*k5_args)
    _assert_close(got, ref, torch.bfloat16)
    assert torch.equal(got, k1.roi_pool_patches_flat(*k1_args))
    dead = [i for i in zero if i < n] if case != "all_zero" else range(n)
    for i in dead:
        assert float(got[i].float().abs().max()) == 0.0
    if n and case != "all_zero":
        assert float(ref.float().abs().max()) > 0.1


@pytest.mark.parametrize("patch", [48, 16])
@pytest.mark.parametrize("resolution", [7, 14])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_equals_k1_on_the_same_boxes(cuda, resolution, dtype, patch):
    """The pooler's own inputs for both layouts (``level_pool_inputs`` and
    ``flat_pool_inputs`` of the same features and boxes, boxes reaching the
    image's right and bottom edges), at the full patch and at a small patch
    class: K5 gives K1's bits, in float32 (both pool_box) and in bfloat16
    (both pool_box_bf16)."""
    p = _inputs(cuda, dtype, resolution, prep=level_pool_inputs)
    f = _inputs(cuda, dtype, resolution)
    assert torch.equal(p.ay, f.ay) and torch.equal(p.ax, f.ax)
    ay = p.ay[:, :, :patch].contiguous()
    ax = p.ax[:, :, :patch + 8].contiguous()
    got = k1.roi_pool_patches(p.kpadded, p.meta, ay, ax, resolution, patch)
    want = k1.roi_pool_patches_flat(f.kcat, f.rows, f.cols, ay, ax,
                                    resolution, patch)
    torch.cuda.synchronize()
    assert float(want.float().abs().max()) > 0.1
    assert torch.equal(got, want)


@pytest.mark.parametrize("resolution", [7, 14])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_matches_plain_version(cuda, resolution, dtype):
    """K5 on per-level buffers against its plain version (K1's tolerances),
    also with the hats sliced to a small patch class, and against K1 on the
    same boxes."""
    p = _inputs(cuda, dtype, resolution, prep=level_pool_inputs)
    before = k1.launches_patches
    got = k1.roi_pool_patches(p.kpadded, p.meta, p.ay, p.ax, resolution)
    torch.cuda.synchronize()
    assert k1.launches_patches == before + 1
    _assert_close(got, k1.roi_pool_patches_reference(
        p.kpadded, p.meta, p.ay, p.ax, resolution), dtype)
    f = _inputs(cuda, dtype, resolution)
    _assert_close(got, k1.roi_pool_patches_flat(f.kcat, f.rows, f.cols, f.ay,
                                                f.ax, resolution), dtype)
    ay, ax = p.ay[:, :, :16].contiguous(), p.ax[:, :, :24].contiguous()
    _assert_close(
        k1.roi_pool_patches(p.kpadded, p.meta, ay, ax, resolution, 16),
        k1.roi_pool_patches_reference(p.kpadded, p.meta, ay, ax, resolution,
                                      16), dtype)


@pytest.mark.parametrize("c_split", [1, 2])
@pytest.mark.parametrize("resolution", [7, 14])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_matches_plain_version(cuda, resolution, dtype, c_split):
    """K6 at whole C and at two C-blocks against its plain version, with
    each image's 64 boxes padded to 70 (chunk 7), and against K5 on the
    same boxes after the padding is cut off."""
    p = _inputs(cuda, dtype, resolution, prep=level_pool_inputs)
    r = resident_pool_inputs(p, resolution, 2, n_images=2, chunk=7,
                             c_split=c_split)
    assert r.pad_per == 6
    args = (r.kpadded, r.meta, r.ay, r.ax, resolution, 48, r.chunk, 2, c_split)
    before = k1.launches_resident
    got = k1.roi_pool_resident(*args)
    torch.cuda.synchronize()
    assert k1.launches_resident == before + 1
    _assert_close(got, k1.roi_pool_resident_reference(*args), dtype)
    cut = got.reshape((2, 70) + got.shape[1:])[:, :64].reshape(
        (128,) + got.shape[1:])
    _assert_close(cut, k1.roi_pool_patches(p.kpadded, p.meta, p.ay, p.ax,
                                           resolution), dtype)


# (H_l, W_l) of the four unpadded levels of the K6 span cases: each image's
# section of level l is (H_l + 48) x (W_l + 56); the two lower levels are
# shorter than a window, so their unpadded corner takes in padding rows, as
# the top levels of the production pyramid do
RESIDENT_LEVELS = ((88, 80), (44, 40), (22, 20), (11, 10))


def _resident_span_inputs(dev, resolution, case, n_per, chunk, n_images=2):
    """K6's inputs for one of SPAN_CASES: four bf16 level buffers of
    ``n_images`` sections at C = 256, random features everywhere (padding
    too, so that a misplaced read shows), ``n_per`` boxes per image on every
    level with origins in each section's unpadded corner (the first four of
    each image at each level's last origin: a window that ends on the
    section's last unpadded row and column), random hats cut to the case's
    span; and K1's inputs on the same cells: the buffers stacked into one,
    zero-padded to the widest."""
    rng = np.random.default_rng(resolution * 100 + n_per + 2)
    c, patch = 256, 48
    bufs = [torch.from_numpy(rng.standard_normal(
        (n_images * (h + patch), w + patch + 8, c)).astype(np.float32)).to(
            dev, torch.bfloat16) for h, w in RESIDENT_LEVELS]
    _, sec_hs, sec_ws = k1.resident_geometry(bufs, n_images, patch)
    max_row = np.array(sec_hs) - patch
    max_col = np.array(sec_ws) - patch - 8
    n = n_images * n_per
    level = rng.integers(0, 4, n)
    row = rng.integers(0, max_row[level] + 1)
    col = rng.integers(0, max_col[level] // 8 + 1) * 8
    for b in range(n_images if n_per >= 4 else 0):
        first = b * n_per + np.arange(4)
        level[first] = np.arange(4)
        row[first], col[first] = max_row, max_col
    meta = np.stack([level, row, col], axis=1).astype(np.int32)
    dead = [b * n_per + i for b in range(n_images)
            for i in SPAN_CASES[case][2] if i < n_per]
    ay, ax = _span_hats(rng, case, resolution, n, dead)
    ay, ax = torch.from_numpy(ay).to(dev), torch.from_numpy(ax).to(dev)
    fcat, base = _stacked(bufs)
    image = np.arange(n) // max(n_per, 1)
    src_h = np.array([h + patch for h, _ in RESIDENT_LEVELS])
    k6 = (tuple(bufs), torch.from_numpy(meta).to(dev), ay, ax, resolution,
          patch, chunk, n_images, 2)
    k1_args = (fcat, torch.from_numpy((base[level] + image * src_h[level]
                                       + row).astype(np.int32)).to(dev),
               torch.from_numpy(col.astype(np.int32)).to(dev), ay, ax,
               resolution)
    return k6, k1_args, dead


@pytest.mark.parametrize("chunk", [1, 37])
@pytest.mark.parametrize("n_per", [0, 37])
@pytest.mark.parametrize("case", sorted(SPAN_CASES))
@pytest.mark.parametrize("resolution", [7, 14])
def test_k6_bf16_spans(cuda, resolution, case, n_per, chunk):
    """K6's bf16 kernel (K1's pool_box_bf16 per box, in K6's image-ordered
    grid, two C-blocks) against its plain version on K1's span cases, two
    images of 37 boxes (a multiple of nothing the kernel tiles by) or none
    (no launch), boxes on every level and windows that end on each
    section's last unpadded row and column, at C = 256; one box per block
    and all 37 of an image in one block (boxes with all-zero hats between
    real ones); and EQUAL to K1 on the same cells."""
    k6_args, k1_args, dead = _resident_span_inputs(cuda, resolution, case,
                                                   n_per, chunk)
    n = 2 * n_per
    before = (k1.launches, k1.launches_resident)
    got = k1.roi_pool_resident(*k6_args)
    torch.cuda.synchronize()
    assert (k1.launches, k1.launches_resident) == (
        before[0], before[1] + (1 if n else 0))
    assert got.shape == (n, resolution, resolution, 256)
    ref = k1.roi_pool_resident_reference(*k6_args)
    _assert_close(got, ref, torch.bfloat16)
    assert torch.equal(got, k1.roi_pool_patches_flat(*k1_args))
    for i in (dead if case != "all_zero" else range(n)):
        assert float(got[i].float().abs().max()) == 0.0
    if n and case != "all_zero":
        assert float(ref.float().abs().max()) > 0.1


@pytest.mark.parametrize("chunk", [1, 2, 7])
@pytest.mark.parametrize("c_split", [1, 2])
@pytest.mark.parametrize("resolution", [7, 14])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_equals_k1_on_the_same_boxes(cuda, resolution, dtype, c_split,
                                        chunk):
    """The pooler's own inputs for both layouts (``resident_pool_inputs``
    and ``flat_pool_inputs`` of the same features and boxes, boxes reaching
    the image's edges, so that the clamp moves windows): K6 gives K1's bits
    after each image's padding is cut off, in float32 (both pool_box) and in
    bfloat16 (both pool_box_bf16), at whole C and two C-blocks, at 1, 2 and
    7 boxes per block.  Two boxes of each image get zero hats, so that at
    chunk 7 an all-zero box sits between real boxes of a block, and each
    image's last block holds one real box and six padding boxes."""
    p = _inputs(cuda, dtype, resolution, prep=level_pool_inputs)
    f = _inputs(cuda, dtype, resolution)
    r = resident_pool_inputs(p, resolution, 2, n_images=2, chunk=chunk,
                             c_split=c_split)
    per = 64 + r.pad_per
    assert r.pad_per == {1: 0, 2: 0, 7: 6}[chunk]
    # the clamp moved some windows: their hats were folded again
    assert not torch.equal(r.ay.reshape(2, per, -1)[:, :64],
                           p.ay.reshape(2, 64, -1))
    ay, ax = f.ay.clone(), f.ax.clone()
    for b in range(2):
        for i in (3, 10):
            ay[b * 64 + i] = 0.0
            r.ay[b * per + i] = 0.0
    before = k1.launches_resident
    got = k1.roi_pool_resident(r.kpadded, r.meta, r.ay, r.ax, resolution, 48,
                               r.chunk, 2, c_split)
    torch.cuda.synchronize()
    assert k1.launches_resident == before + 1
    cut = got.reshape((2, per) + got.shape[1:])[:, :64].reshape(
        (128,) + got.shape[1:])
    want = k1.roi_pool_patches_flat(f.kcat, f.rows, f.cols, ay, ax,
                                    resolution)
    torch.cuda.synchronize()
    assert float(want.float().abs().max()) > 0.1
    assert torch.equal(cut, want)


def test_k6_bf16_raises_on_c_blocks_of_other_than_32_channels(cuda):
    """pool_box_bf16 bounds its 32-channel slice by C, not by the C-block:
    a bfloat16 call whose C-block is not a multiple of 32 raises and
    launches nothing (float32 takes any C-block); so do the inputs the
    other bf16 kernels refuse."""
    p = _inputs(cuda, torch.bfloat16, 7, n=8, prep=level_pool_inputs)
    r = resident_pool_inputs(p, 7, 2, n_images=2, chunk=4, c_split=4)
    args = (r.meta, r.ay, r.ax, 7, 48, r.chunk, 2)
    before = k1.launches_resident
    with pytest.raises(ValueError, match="multiple of 32"):
        k1.roi_pool_resident(r.kpadded, *args, 4)
    c12 = [torch.zeros(f.shape[:2] + (12,), dtype=torch.bfloat16,
                       device=cuda) for f in r.kpadded]
    with pytest.raises(ValueError, match="multiple of 8"):
        k1.roi_pool_resident(c12, *args, 1)
    shifted = torch.zeros(r.kpadded[1].numel() + 1, dtype=torch.bfloat16,
                          device=cuda)[1:].view(r.kpadded[1].shape)
    with pytest.raises(ValueError, match="aligned"):
        k1.roi_pool_resident([r.kpadded[0], shifted] + list(r.kpadded[2:]),
                             *args, 1)
    assert k1.launches_resident == before
    f32 = [f.float() for f in r.kpadded]
    out = k1.roi_pool_resident(f32, *args, 4)
    torch.cuda.synchronize()
    assert k1.launches_resident == before + 1
    _assert_close(out, k1.roi_pool_resident_reference(f32, *args, 4),
                  torch.float32)


def test_k5_k6_raise_instead_of_falling_back(cuda, monkeypatch):
    p = _inputs(cuda, torch.float32, 7, n=8, prep=level_pool_inputs)
    r = resident_pool_inputs(p, 7, 2, n_images=2, chunk=4, c_split=1)
    with pytest.raises(ValueError, match="is on cpu"):
        k1.roi_pool_patches(p.kpadded, p.meta.cpu(), p.ay, p.ax, 7)
    with pytest.raises(ValueError, match="resolutions"):
        k1.roi_pool_patches(p.kpadded, p.meta, p.ay[:, :5].contiguous(),
                            p.ax[:, :5].contiguous(), 5)
    with pytest.raises(ValueError, match="clamped"):
        k1.roi_pool_resident(p.kpadded, p.meta, p.ay, p.ax, 7, 48, 4, 2)
    # bfloat16 inputs that pool_box_bf16 does not take raise: C not a
    # multiple of 8, a misaligned level buffer, a patch above 48; N = 0
    # launches nothing
    before = k1.launches_patches
    b16 = [f.to(torch.bfloat16) for f in p.kpadded]
    c12 = [torch.zeros(f.shape[:2] + (12,), dtype=torch.bfloat16,
                       device=cuda) for f in p.kpadded]
    with pytest.raises(ValueError, match="multiple of 8"):
        k1.roi_pool_patches(c12, p.meta, p.ay, p.ax, 7)
    shifted = torch.zeros(b16[1].numel() + 1, dtype=torch.bfloat16,
                          device=cuda)[1:].view(b16[1].shape)
    with pytest.raises(ValueError, match="aligned"):
        k1.roi_pool_patches([b16[0], shifted] + b16[2:], p.meta, p.ay, p.ax,
                            7)
    ay56 = torch.zeros((p.meta.shape[0], 7, 56), device=cuda)
    ax64 = torch.zeros((p.meta.shape[0], 7, 64), device=cuda)
    with pytest.raises(ValueError, match="patch of 1 to 48"):
        k1.roi_pool_patches(b16, p.meta, ay56, ax64, 7, 56)
    out = k1.roi_pool_patches(b16, p.meta[:0], p.ay[:0], p.ax[:0], 7)
    assert out.shape == (0, 7, 7, 64) and out.dtype == torch.bfloat16
    assert k1.launches_patches == before
    # a kernel that cannot be built raises; the plain version is not taken
    before = (k1.launches_patches, k1.launches_resident)
    monkeypatch.setattr(k1, "_libs", {})
    monkeypatch.setattr(k1, "NVCC_FLAGS", ["--no-such-flag"])
    with pytest.raises(RuntimeError, match="building roi_pool_levels failed"):
        k1.roi_pool_patches(p.kpadded, p.meta, p.ay, p.ax, 7)
    with pytest.raises(RuntimeError,
                       match="building roi_pool_resident failed"):
        k1.roi_pool_resident(r.kpadded, r.meta, r.ay, r.ax, 7, 48, r.chunk, 2)
    assert (k1.launches_patches, k1.launches_resident) == before


def _crown_boxes(n, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 8.0 * np.sqrt(n), (n, 2))
    wh = rng.uniform(2, 35, (n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], axis=1).astype(np.float32)
    boxes[::17, 2] = boxes[::17, 0]                       # zero-area boxes
    boxes[1::29] = boxes[0:-1:29]                         # identical boxes
    areas = (wh[:, 0] * wh[:, 1] * rng.uniform(0.5, 1.5, n)).astype(np.float32)
    areas[::23] = 0.0                                     # the 1e-9 floor
    return torch.from_numpy(boxes), torch.from_numpy(areas)


@pytest.mark.parametrize("mode", ["dedupe", "containment", "iou"])
@pytest.mark.parametrize("n,rows", [(1000, None), (1000, (400, 477)),
                                    (1, None), (4099, (0, 4099)),
                                    (2050, (33, 1061)), (1008, None),
                                    (2064, (5, 1030))])
def test_pairwise_kernels_equal_plain_versions(cuda, mode, n, rows):
    """Exact equality of the uint8 masks: the kernel is built without FMA
    contraction and keeps the plain version's order of operations.  Square,
    row-block, ragged (N not a multiple of 16: the chunk that N cuts takes
    byte stores, and so do all rows where the pitch is not a multiple of
    16), N a multiple of 16 but not of a block's 2048 columns (16-byte
    stores up to the last chunk), an odd row count (the last pair of rows
    holds one) and single-box shapes."""
    boxes, areas = _crown_boxes(n)
    b, a = boxes.to(cuda), areas.to(cuda)
    rb = None if rows is None else b[rows[0]:rows[1]].contiguous()
    ra = None if rows is None else a[rows[0]:rows[1]].contiguous()
    before = k234.launches[mode]
    if mode == "iou":
        got = k234.pairwise_iou_mask(b, 0.5, rows=rb)
        ref = k234.iou_mask_reference(b if rb is None else rb, b, 0.5)
    elif mode == "containment":
        got = k234.pairwise_containment_mask(b, 0.9, rows=rb)
        ref = k234.containment_mask_reference(b if rb is None else rb, b, 0.9)
        if rb is None:
            ref.fill_diagonal_(0)
    else:
        got = k234.pairwise_dedupe_mask(b, a, 0.5, 0.3, rows=rb, row_areas=ra)
        b5 = torch.cat([b, a[:, None]], dim=1)
        a5 = b5 if rb is None else torch.cat([rb, ra[:, None]], dim=1)
        ref = k234.dedupe_mask_reference(a5, b5, 0.5, 0.3)
    torch.cuda.synchronize()
    assert k234.launches[mode] == before + 1
    assert got.dtype == torch.uint8 and got.shape == ref.shape
    assert int((got != ref).sum()) == 0
    # and the CPU path (the plain version) gives the same mask
    cpu = {"iou": lambda: k234.pairwise_iou_mask(
               boxes, 0.5, rows=None if rb is None else rb.cpu()),
           "containment": lambda: k234.pairwise_containment_mask(
               boxes, 0.9, rows=None if rb is None else rb.cpu()),
           "dedupe": lambda: k234.pairwise_dedupe_mask(
               boxes, areas, 0.5, 0.3, rows=None if rb is None else rb.cpu(),
               row_areas=None if ra is None else ra.cpu())}[mode]()
    assert torch.equal(cpu, got.cpu())


def test_pairwise_kernels_raise_instead_of_falling_back(cuda, monkeypatch):
    boxes, areas = _crown_boxes(64)
    b, a = boxes.to(cuda), areas.to(cuda)
    with pytest.raises(ValueError, match="is on cpu"):
        k234.pairwise_iou_mask(b, 0.5, rows=boxes)
    with pytest.raises(TypeError, match="float32"):
        k234.pairwise_containment_mask(b.double(), 0.9)
    with pytest.raises(ValueError, match="contiguous"):
        k234.pairwise_iou_mask(b, 0.5, rows=b.repeat(1, 2)[:, ::2])
    # an empty relation returns without a launch
    before = dict(k234.launches)
    assert k234.pairwise_dedupe_mask(b[:0], a[:0], 0.5).shape == (0, 0)
    assert k234.launches == before
    # a kernel that cannot be built raises; the plain version is not taken
    monkeypatch.setattr(k234, "_lib", None)
    monkeypatch.setattr(k234, "NVCC_FLAGS", ["--no-such-flag"])
    with pytest.raises(RuntimeError, match="building pairwise_boxes failed"):
        k234.pairwise_iou_mask(b, 0.5)
    assert k234.launches == before


def _plain_mask(mode, boxes, areas, rows, thr):
    """The plain uint8 relation of K2 / K3 on the rows (start, stop) or the
    square case."""
    rb = boxes if rows is None else boxes[rows[0]:rows[1]]
    if mode == "containment":
        ref = k234.containment_mask_reference(rb, boxes, thr[0])
        return ref.fill_diagonal_(0) if rows is None else ref
    b5 = torch.cat([boxes, areas[:, None]], dim=1)
    a5 = b5 if rows is None else b5[rows[0]:rows[1]]
    return k234.dedupe_mask_reference(a5, b5, thr[0], thr[1])


def _bits_call(mode, b, a, rows, thr):
    rb = None if rows is None else b[rows[0]:rows[1]].contiguous()
    if mode == "containment":
        return k234.pairwise_containment_bits(b, thr[0], rows=rb)
    ra = None if rows is None else a[rows[0]:rows[1]].contiguous()
    return k234.pairwise_dedupe_bits(b, a, thr[0], thr[1], rows=rb,
                                     row_areas=ra)


PAIR_THRESHOLDS = {("containment", "default"): (0.9, 0.0),
                   ("containment", "le_0"): (0.0, 0.0),
                   ("dedupe", "default"): (0.5, 0.3),
                   ("dedupe", "le_0"): (-0.1, 0.3)}


@pytest.mark.parametrize("mode", ["dedupe", "containment"])
@pytest.mark.parametrize("thr_name", ["default", "le_0"])
@pytest.mark.parametrize("n,rows", [(1000, None), (1000, (400, 477)),
                                    (1, None), (4099, (0, 4099)),
                                    (2050, (33, 1061))])
def test_pairwise_bits_and_pairs_equal_plain_versions(cuda, mode, thr_name,
                                                      n, rows):
    """The bit-packed relation kernel: the packed bytes EQUAL
    pack_bits_rows of the plain mask, zero past N up to the kernel's pitch
    (N = 1000, 4099 and 2050 leave padded bytes); relation_pairs EQUALS
    np.nonzero of the plain mask (row offset added, diagonal dropped) as
    whole arrays, order included.  Thresholds <= 0 make every pair that does
    not meet a hit."""
    thr = PAIR_THRESHOLDS[(mode, thr_name)]
    boxes, areas = _crown_boxes(n)
    b, a = boxes.to(cuda), areas.to(cuda)
    before = dict(k234.launches)
    got = _bits_call(mode, b, a, rows, thr)
    torch.cuda.synchronize()
    assert k234.launches[mode] == before[mode] + 1
    ref = _plain_mask(mode, boxes, areas, rows, thr)
    nbytes = (n + 7) // 8
    assert got.dtype == torch.uint8 and got.shape == (ref.shape[0], nbytes)
    assert torch.equal(got.cpu(), k234.pack_bits_rows(ref))
    pitch = got.stride(0)
    assert pitch % 16 == 0 and pitch >= nbytes
    padded = got.as_strided((got.shape[0], pitch), (pitch, 1))
    assert not padded[:, nbytes:].any()
    start = 0 if rows is None else rows[0]
    pairs = k234.relation_pairs(got, n, start, True)
    torch.cuda.synchronize()
    assert k234.launches["pairs"] == before["pairs"] + 1
    ii, jj = np.nonzero(ref.numpy())
    ii = ii + start
    keep = ii != jj
    assert pairs.dtype == torch.int32
    np.testing.assert_array_equal(pairs.cpu().numpy(),
                                  np.stack([ii[keep], jj[keep]]))
    # the plain version on the same card tensor: the same arrays
    assert torch.equal(
        k234.relation_pairs_reference(got, n, start, True).cpu(),
        pairs.cpu())
    # a block whose rows are not word-readable in place (a tight copy:
    # ceil(N/8) % 4 != 0 for every N here) is refused, not copied
    assert nbytes % 4 != 0
    tight = torch.empty(got.shape, dtype=torch.uint8, device=cuda).copy_(got)
    before = k234.launches["pairs"]
    with pytest.raises(ValueError, match="4-byte words"):
        k234.relation_pairs(tight, n, start, True)
    assert k234.launches["pairs"] == before
    # without the diagonal rule
    kept_all = k234.relation_pairs(got, n, start, False).cpu().numpy()
    np.testing.assert_array_equal(kept_all, np.stack([ii, jj]))


@pytest.mark.parametrize("n", [1, 31, 33, 4099])
@pytest.mark.parametrize("fill", ["empty", "all_ones", "random"])
def test_relation_pairs_on_bits_made_by_hand(cuda, n, fill):
    """The compaction kernels on packed blocks made with numpy: an empty
    relation (the count kernel only), an all-ones one, a random one; N % 8
    and N % 32 != 0; rows offset so that the diagonal falls inside."""
    rng = np.random.default_rng(n)
    m = {"empty": np.zeros((70, n), np.uint8),
         "all_ones": np.ones((70, n), np.uint8),
         "random": (rng.random((70, n)) < 0.2).astype(np.uint8)}[fill]
    # at the kernel's pitch, as the bit-packed wrappers lay their blocks out
    nbytes = (n + 7) // 8
    padded = torch.zeros((70, k234._bits_pitch(n)), dtype=torch.uint8)
    padded[:, :nbytes] = torch.from_numpy(np.packbits(m, axis=1))
    bits = padded.to(cuda)[:, :nbytes]
    before = k234.launches["pairs"]
    got = k234.relation_pairs(bits, n, row_offset=3, drop_diagonal=True)
    torch.cuda.synchronize()
    assert k234.launches["pairs"] == before + 1
    ii, jj = np.nonzero(m)
    ii = ii + 3
    keep = ii != jj
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  np.stack([ii[keep], jj[keep]]))


def test_pairwise_bits_raise_instead_of_falling_back(cuda, monkeypatch):
    boxes, areas = _crown_boxes(64)
    b, a = boxes.to(cuda), areas.to(cuda)
    with pytest.raises(ValueError, match="is on cpu"):
        k234.pairwise_containment_bits(b, 0.9, rows=boxes)
    with pytest.raises(ValueError, match="is on cpu"):
        k234.pairwise_dedupe_bits(b, a, 0.5, rows=boxes[:3],
                                  row_areas=areas[:3])
    with pytest.raises(TypeError, match="float32"):
        k234.pairwise_dedupe_bits(b.double(), a, 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        k234.pairwise_containment_bits(b, 0.9, rows=b.repeat(1, 2)[:, ::2])
    with pytest.raises(TypeError, match="uint8"):
        k234.relation_pairs(torch.zeros((4, 8), dtype=torch.int32,
                                        device=cuda), 64)
    with pytest.raises(ValueError, match="bytes per row"):
        k234.relation_pairs(torch.zeros((4, 7), dtype=torch.uint8,
                                        device=cuda), 64)
    # the rows and the boxes must share a device before any launch
    with pytest.raises(ValueError, match="rows are on"):
        k234._launch_bits("containment", boxes, b, 0.9, 0.0, False)
    with pytest.raises(ValueError, match="rows are on"):
        k234._launch("dedupe", b.cpu(), b, 0.5, 0.3)
    # empty blocks return without a launch
    before = dict(k234.launches)
    assert k234.pairwise_containment_bits(b, 0.9, rows=b[:0]).shape == (0, 8)
    assert k234.pairwise_dedupe_bits(b[:0], a[:0], 0.5).shape == (0, 0)
    assert k234.relation_pairs(torch.zeros((0, 8), dtype=torch.uint8,
                                           device=cuda), 64).shape == (2, 0)
    assert k234.launches == before
    # kernels that cannot be built raise; the plain versions are not taken
    bits = k234.pairwise_containment_bits(b, 0.9)
    before = dict(k234.launches)
    monkeypatch.setattr(k234, "_lib", None)
    monkeypatch.setattr(k234, "NVCC_FLAGS", ["--no-such-flag"])
    with pytest.raises(RuntimeError, match="building pairwise_boxes failed"):
        k234.pairwise_dedupe_bits(b, a, 0.5)
    with pytest.raises(RuntimeError, match="building pairwise_boxes failed"):
        k234.relation_pairs(bits, 64)
    assert k234.launches == before


@pytest.mark.parametrize("mode", ["dedupe", "containment"])
@pytest.mark.parametrize("thr_name", ["default", "le_0"])
def test_pairwise_relation_kernel_on_huge_coordinates(cuda, mode, thr_name):
    """Boxes reaching past 2^126 (finite) send their warps down the whole
    formula for every pair; both forms still EQUAL the plain version."""
    thr = PAIR_THRESHOLDS[(mode, thr_name)]
    boxes, areas = _crown_boxes(700, seed=4)
    boxes[::37, 0], boxes[::37, 2] = -3e38, 3e38
    boxes[5, 1], boxes[5, 3] = -1e38, 2e38
    b, a = boxes.to(cuda), areas.to(cuda)
    for rows in (None, (100, 300)):
        ref = _plain_mask(mode, boxes, areas, rows, thr)
        got = _bits_call(mode, b, a, rows, thr)
        assert torch.equal(got.cpu(), k234.pack_bits_rows(ref))
        rb = None if rows is None else b[rows[0]:rows[1]].contiguous()
        if mode == "containment":
            mask = k234.pairwise_containment_mask(b, thr[0], rows=rb)
        else:
            ra = None if rows is None else a[rows[0]:rows[1]].contiguous()
            mask = k234.pairwise_dedupe_mask(b, a, thr[0], thr[1], rows=rb,
                                             row_areas=ra)
        assert torch.equal(mask.cpu(), ref)


def _mask_call(mode, b, a, rows, thr):
    rb = None if rows is None else b[rows[0]:rows[1]].contiguous()
    if mode == "iou":
        return k234.pairwise_iou_mask(b, thr[0], rows=rb)
    if mode == "containment":
        return k234.pairwise_containment_mask(b, thr[0], rows=rb)
    ra = None if rows is None else a[rows[0]:rows[1]].contiguous()
    return k234.pairwise_dedupe_mask(b, a, thr[0], thr[1], rows=rb,
                                     row_areas=ra)


def _plain_mask_any(mode, boxes, areas, rows, thr):
    if mode != "iou":
        return _plain_mask(mode, boxes, areas, rows, thr)
    rb = boxes if rows is None else boxes[rows[0]:rows[1]]
    return k234.iou_mask_reference(rb, boxes, thr[0])


MASK_THRESHOLDS = {**PAIR_THRESHOLDS, ("iou", "default"): (0.5, 0.0),
                   ("iou", "le_0"): (-0.1, 0.0)}


@pytest.mark.parametrize("mode", ["dedupe", "containment", "iou"])
@pytest.mark.parametrize("thr_name", ["default", "le_0"])
@pytest.mark.parametrize("boxes_kind", ["crowns", "huge_coordinates"])
def test_pairwise_masks_at_every_threshold(cuda, mode, thr_name, boxes_kind):
    """The uint8 form of the relation kernel (K4's only form) EQUALS the
    plain version with thresholds <= 0 (every pair that does not meet is a
    hit, so whole rows of ones take the 16-byte stores) and with boxes past
    2^126 (their warps take the whole formula), square and row-block, N a
    multiple of 16 (1024) and not (1000)."""
    thr = MASK_THRESHOLDS[(mode, thr_name)]
    for n, rows in ((1024, None), (1024, (100, 333)), (1000, (7, 200))):
        boxes, areas = _crown_boxes(n, seed=5)
        if boxes_kind == "huge_coordinates":
            boxes[::37, 0], boxes[::37, 2] = -3e38, 3e38
        b, a = boxes.to(cuda), areas.to(cuda)
        before = k234.launches[mode]
        got = _mask_call(mode, b, a, rows, thr)
        torch.cuda.synchronize()
        assert k234.launches[mode] == before + 1
        assert torch.equal(got.cpu(), _plain_mask_any(mode, boxes, areas,
                                                      rows, thr))


@pytest.mark.parametrize("mode", ["dedupe", "containment", "iou"])
@pytest.mark.parametrize("shift", [1, 4, 8])
def test_pairwise_mask_into_an_unaligned_block(cuda, mode, shift):
    """A mask block whose base is not 16-byte aligned (the wrappers' own
    blocks always are) takes the byte stores and still EQUALS the plain
    version; the bytes before and after it are left alone."""
    boxes, areas = _crown_boxes(1024, seed=6)
    b, a = boxes.to(cuda), areas.to(cuda)
    if mode == "dedupe":
        b = torch.cat([b, a[:, None]], dim=1)
    rows = b[:77].contiguous()
    n = b.shape[0]
    thr = MASK_THRESHOLDS[(mode, "default")]
    flat = torch.full((77 * n + 32,), 7, dtype=torch.uint8, device=cuda)
    out = flat[shift:shift + 77 * n].view(77, n)
    assert out.data_ptr() % 16 != 0
    k234._launch_into(mode, rows, b, out, thr[0], thr[1], packed=False)
    torch.cuda.synchronize()
    ref = _plain_mask_any(mode, boxes, areas, (0, 77), thr)
    assert torch.equal(out.cpu(), ref)
    assert (flat[:shift] == 7).all() and (flat[shift + 77 * n:] == 7).all()
