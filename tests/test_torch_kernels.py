"""K1 (the flat ROIAlign patch pooler) on the card against its plain version.

These tests need an NVIDIA GPU: they carry the ``gpu`` marker and skip
elsewhere.  On the card: ``python -m pytest tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

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
