"""K1 (the flat ROIAlign patch pooler) and K2/K3/K4 (the pairwise box-relation
masks) on the card against their plain versions.

These tests need an NVIDIA GPU: they carry the ``gpu`` marker and skip
elsewhere.  On the card: ``python -m pytest tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from treedetection_tpu_torch.ops.kernels import pairwise as k234
from treedetection_tpu_torch.ops.kernels import roi_align as k1
from treedetection_tpu_torch.ops.roi_align import flat_pool_inputs

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(dev, dtype, resolution, b=2, n=64, c=64, seed=0):
    rng = np.random.default_rng(seed)
    fmaps = [torch.from_numpy(rng.standard_normal(
        (b, 128 >> i, 128 >> i, c)).astype(np.float32)).to(dev, dtype)
        for i in range(4)]
    ctr = rng.uniform(0, 512, (b, n, 2))
    wh = rng.uniform(8, 200, (b, n, 2))
    boxes = np.clip(np.concatenate([ctr - wh / 2, ctr + wh / 2], -1), 0, 512)
    boxes = torch.from_numpy(boxes.astype(np.float32)).to(dev)
    return flat_pool_inputs(fmaps, boxes, resolution, (4, 8, 16, 32))


@pytest.mark.parametrize("resolution", [7, 14])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_matches_plain_version(cuda, resolution, dtype):
    """float32: summation order only, atol 2e-5 of the peak.  bfloat16: both
    accumulate in float32 and round once, so one bf16 ulp (2^-7 relative)
    plus 1e-5 of the peak where sums cancel."""
    p = _inputs(cuda, dtype, resolution)
    args = (p.kcat, p.rows, p.cols, p.ay, p.ax, resolution)
    before = k1.launches
    got = k1.roi_pool_patches_flat(*args)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    ref = k1.roi_pool_patches_flat_reference(*args).float()
    peak = max(1.0, float(ref.abs().max()))
    if dtype == torch.float32:
        atol, rtol = 2e-5 * peak, 0.0
    else:
        atol, rtol = 1e-5 * peak, 2.0 ** -7
    assert ((got.float() - ref).abs() <= atol + rtol * ref.abs()).all()


def test_k1_raises_instead_of_falling_back(cuda):
    p = _inputs(cuda, torch.float32, 7, n=8)
    with pytest.raises(ValueError, match="resolutions"):
        k1.roi_pool_patches_flat(p.kcat, p.rows, p.cols,
                                 p.ay[:, :5].contiguous(),
                                 p.ax[:, :5].contiguous(), 5)
    with pytest.raises(ValueError, match="is on cpu"):
        k1.roi_pool_patches_flat(p.kcat, p.rows.cpu(), p.cols, p.ay, p.ax, 7)


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
                                    (2050, (33, 1061))])
def test_pairwise_kernels_equal_plain_versions(cuda, mode, n, rows):
    """Exact equality of the uint8 masks: the kernel is built without FMA
    contraction and keeps the plain version's order of operations.  Square,
    row-block, ragged (N not a multiple of 4: the byte-store path) and
    single-box shapes."""
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
