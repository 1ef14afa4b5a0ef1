"""The port's NDVI, 16-bit rescale and model-input transform, class-aware
NMS and mask pasting against the JAX package's, on the CPU in float32.
Inputs are made with numpy from a seed and fed to both packages."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from treedetection_tpu.ops import image as jimage  # noqa: E402
from treedetection_tpu.ops import masks as jmasks  # noqa: E402
from treedetection_tpu.ops import nms as jnms  # noqa: E402
from treedetection_tpu_torch.ops import image as timage  # noqa: E402
from treedetection_tpu_torch.ops import masks as tmasks  # noqa: E402
from treedetection_tpu_torch.ops import nms as tnms  # noqa: E402


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_ndvi_and_rescale_match_jax(dtype):
    """Elementwise float32: within 1e-6 (the two may round a division in the
    last ulp differently); dark pixels (R = NIR = 0) give 0."""
    rng = np.random.default_rng(0)
    hi = 65535 if dtype == np.uint16 else 255
    x = rng.integers(0, hi + 1, (3, 37, 41, 4)).astype(dtype)
    x[0, :4, :4] = 0
    for name in ("ndvi_from_rgbi", "rescale_16bit"):
        got = getattr(timage, name)(torch.from_numpy(x))
        want = np.asarray(getattr(jimage, name)(jnp.asarray(x)))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert not timage.ndvi_from_rgbi(torch.from_numpy(x))[0, :4, :4].any()


@pytest.mark.parametrize("size,is_16bit,batched", [
    (64, False, False), (48, True, True), (37, False, True)])
def test_rgbi_to_model_input_matches_jax(size, is_16bit, batched):
    """Rescale, BGR reorder and normalization within 1e-6; through a resize
    within the resize's tolerance of ``test_torch_ops`` (1e-4)."""
    rng = np.random.default_rng(1)
    shape = (2, 64, 64, 4) if batched else (64, 64, 4)
    x = rng.integers(0, 65536 if is_16bit else 256, shape).astype(
        np.uint16 if is_16bit else np.uint8)
    mean, std = (100.0, 110.0, 120.0), (57.375, 57.12, 58.395)
    got = timage.rgbi_to_model_input(torch.from_numpy(x.astype(np.int32)),
                                     size, mean, std, is_16bit)
    want = np.asarray(jimage.rgbi_to_model_input(
        jnp.asarray(x.astype(np.int32)), size, mean, std, is_16bit))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 if size == 64 else 1e-4)


def _boxes(rng, n, img=200.0):
    c = rng.uniform(0, img, (n, 2))
    wh = rng.uniform(4, img / 4, (n, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)


@pytest.mark.parametrize("seed,n,classes", [(0, 60, 1), (1, 120, 3),
                                            (2, 200, 5), (3, 7, 2)])
def test_batched_nms_and_top_k_match_jax(seed, n, classes):
    """The same keep set; then the same top-k entries in the same order
    (ties to the lower index), -inf padded past the kept ones."""
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng, n)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[::9] = scores[0]                                  # tied scores
    scores[-1] = -np.inf
    idxs = rng.integers(0, classes, n)
    got = tnms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                           torch.from_numpy(idxs), 0.5)
    want = np.asarray(jnms.batched_nms(jnp.asarray(boxes),
                                       jnp.asarray(scores),
                                       jnp.asarray(idxs), 0.5))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < n
    k = min(int(want.sum()) + 3, n)
    tb, ts, ti = tnms.top_k_after_nms(torch.from_numpy(boxes),
                                      torch.from_numpy(scores), got, k)
    jb, js, ji = jnms.top_k_after_nms(jnp.asarray(boxes),
                                      jnp.asarray(scores),
                                      jnp.asarray(want), k)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_batched_nms_groups_never_suppress_each_other():
    boxes = torch.tensor([[0, 0, 10, 10], [0, 0, 10, 10], [1, 1, 10, 10]],
                         dtype=torch.float32)
    scores = torch.tensor([0.9, 0.8, 0.7])
    assert tnms.nms_mask(boxes, scores, 0.5).tolist() == [True, False, False]
    assert tnms.batched_nms(boxes, scores, torch.tensor([0, 1, 1]),
                            0.5).tolist() == [True, True, False]


@pytest.mark.parametrize("seed,n,r,h,w", [(0, 12, 28, 64, 80),
                                          (1, 30, 14, 50, 50),
                                          (2, 1, 28, 33, 17)])
def test_paste_masks_match_jax(seed, n, r, h, w):
    """Equal boolean masks away from pixels whose sampled value lies within
    1e-6 of the threshold (found as the pixels that differ between the
    port's pastes at threshold -/+ 1e-6); boxes that cross the image edge,
    thin ones and degenerate ones included."""
    rng = np.random.default_rng(seed)
    masks = rng.uniform(0, 1, (n, r, r)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(-10, max(h, w), (n, 2)),
                            np.zeros((n, 2))], 1).astype(np.float32)
    boxes[:, 2:] = boxes[:, :2] + rng.uniform(0.5, 40, (n, 2))
    boxes[0, 2] = boxes[0, 0]                               # zero width
    tm, tb = torch.from_numpy(masks), torch.from_numpy(boxes)
    got = tmasks.paste_masks_in_image(tm, tb, h, w).numpy()
    want = np.asarray(jmasks.paste_masks_in_image(
        jnp.asarray(masks), jnp.asarray(boxes), h, w))
    near = (tmasks.paste_masks_in_image(tm, tb, h, w, 0.5 - 1e-6).numpy()
            != tmasks.paste_masks_in_image(tm, tb, h, w, 0.5 + 1e-6).numpy())
    assert got.shape == want.shape == (n, h, w) and got.dtype == bool
    assert near.sum() <= 2
    np.testing.assert_array_equal(got[~near], want[~near])
    np.testing.assert_array_equal(
        tmasks.mask_areas(torch.from_numpy(got)).numpy(),
        np.asarray(jmasks.mask_areas(jnp.asarray(got))))
