"""The port's tensor ops against the JAX package's, on the CPU in float32
(the poolers also in bfloat16).

Inputs are made with numpy from a seed and fed to both packages.  The K1
pooler's plain version is held against the Pallas kernel run in interpret
mode, as the JAX package's own tests run it.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from treedetection_tpu_torch.models.anchors import pyramid_anchors  # noqa: E402
from treedetection_tpu_torch.ops import boxes as tboxes  # noqa: E402
from treedetection_tpu_torch.ops.image import (  # noqa: E402
    normalize_bgr, resize_bilinear)
from treedetection_tpu_torch.ops.kernels.roi_align import (  # noqa: E402
    hat_spans, roi_pool_patches_flat, roi_pool_patches_flat_reference)
from treedetection_tpu_torch.ops.nms import nms_mask, stable_topk  # noqa: E402
from treedetection_tpu_torch.ops.roi_align import (  # noqa: E402
    flat_pool_inputs, multilevel_roi_align_batched)


def _boxes(rng, n, img=256.0):
    c = rng.uniform(0, img, (n, 2))
    wh = rng.uniform(4, img / 3, (n, 2))
    b = np.concatenate([c - wh / 2, c + wh / 2], 1)
    return np.clip(b, 0, img).astype(np.float32)


def test_box_math_matches_jax():
    """IoU, delta decoding and clipping: float32 elementwise math, so 1e-6
    relative (exp and division may round differently in the last ulp)."""
    from treedetection_tpu.ops import boxes as jboxes
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 40), _boxes(rng, 30)
    b[3] = b[3, [0, 1, 0, 1]]                       # a zero-area box
    np.testing.assert_allclose(
        tboxes.box_iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jboxes.box_iou_matrix(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6, atol=1e-7)
    d = rng.normal(0, 2, (40, 4)).astype(np.float32)
    d[0, 2:] = 10.0                                  # hits the scale clamp
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        got = tboxes.apply_deltas(torch.from_numpy(d), torch.from_numpy(a), w)
        want = jboxes.apply_deltas(jnp.asarray(d), jnp.asarray(a), w)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-4)
    wide = (a - 50) * 3
    np.testing.assert_array_equal(
        tboxes.clip_boxes(torch.from_numpy(wide), 200, 300).numpy(),
        np.asarray(jboxes.clip_boxes(jnp.asarray(wide), 200, 300)))


def test_nms_matches_jax_with_ties_and_neg_inf():
    """Greedy keep masks are identical, including tied scores (resolved in
    index order by the stable sort) and -inf entries (never kept); the
    batched call equals per-row calls."""
    from treedetection_tpu.ops.nms import nms_mask as jax_nms
    rows = []
    for seed in range(4):
        r = np.random.default_rng(seed)
        bx = _boxes(r, 120, img=100.0)
        sc = np.round(r.uniform(0, 1, 120), 1).astype(np.float32)  # ties
        sc[r.uniform(size=120) < 0.2] = -np.inf
        rows.append((bx, sc))
    bxs = np.stack([b for b, _ in rows])
    scs = np.stack([s for _, s in rows])
    got = nms_mask(torch.from_numpy(bxs), torch.from_numpy(scs), 0.5).numpy()
    for i, (bx, sc) in enumerate(rows):
        want = np.asarray(jax_nms(jnp.asarray(bx), jnp.asarray(sc), 0.5))
        np.testing.assert_array_equal(got[i], want)
        assert not got[i][np.isneginf(sc)].any()


def test_stable_topk_breaks_ties_like_jax():
    """``stable_topk`` reproduces ``jax.lax.top_k``'s lower-index-first tie
    order on 0/1/2 flags and -inf padding, where ``torch.topk`` is free to
    differ."""
    rng = np.random.default_rng(2)
    vals = rng.integers(0, 3, (3, 200)).astype(np.float32)
    vals[:, ::7] = -np.inf
    for k in (5, 37, 200):
        tv, ti = stable_topk(torch.from_numpy(vals), k)
        jv, ji = jax.lax.top_k(jnp.asarray(vals), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_pyramid_anchors_match_jax():
    from treedetection_tpu.models.anchors import pyramid_anchors_jnp
    for size in (128, 1024):
        got = pyramid_anchors(size)
        want = pyramid_anchors_jnp(size)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("src,dst", [(456, 1024), (192, 96)])
def test_normalize_and_resize_match_jax(src, dst):
    """uint8 RGB -> normalized BGR -> bilinear resize: the same half-pixel
    interpolation matrices as two float32 matmuls (1e-4 absolute on values
    of magnitude ~2: summation order)."""
    from treedetection_tpu.ops.image import (
        normalize_bgr as jnorm, resize_bilinear as jresize)
    rng = np.random.default_rng(src)
    raw = rng.integers(0, 256, (2, src, src, 3), dtype=np.uint8)
    mean, std = (103.53, 116.28, 123.675), (57.375, 57.12, 58.395)
    xt = normalize_bgr(torch.from_numpy(raw), mean, std)
    xj = jnorm(jnp.asarray(raw), mean, std)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(resize_bilinear(xt, dst, dst).numpy(),
                               np.asarray(jresize(xj, dst, dst)), atol=1e-4)
    one = rng.standard_normal((src, src, 4)).astype(np.float32)   # HWC
    np.testing.assert_allclose(
        resize_bilinear(torch.from_numpy(one), dst, dst).numpy(),
        np.asarray(jresize(jnp.asarray(one), dst, dst)), atol=1e-4)


def _crown_flat_inputs(resolution, seed, c=16):
    """K1's inputs in bfloat16 from real boxes: the level-concatenated
    buffer and bilinear hats with narrow spans, as the pooler builds them."""
    rng = np.random.default_rng(seed)
    fmaps = [torch.from_numpy(rng.standard_normal(
        (2, 64 >> i, 64 >> i, c)).astype(np.float32)).to(torch.bfloat16)
        for i in range(4)]
    ctr = rng.uniform(0, 256, (2, 12, 2))
    wh = rng.uniform(8, 120, (2, 12, 2))
    boxes = np.clip(np.concatenate([ctr - wh / 2, ctr + wh / 2], -1), 0, 256)
    p = flat_pool_inputs(fmaps, torch.from_numpy(boxes.astype(np.float32)),
                         resolution, (4, 8, 16, 32))
    return [p.kcat, p.rows, p.cols, p.ay, p.ax]


# ids keep the float32 cases' names of before the bfloat16 cases
@pytest.mark.parametrize("resolution,dtype", [
    (7, "float32"), (14, "float32"), (7, "bfloat16"), (14, "bfloat16")],
    ids=["7", "14", "bf16-7", "bf16-14"])
def test_k1_plain_matches_pallas_interpret(resolution, dtype):
    """K1's plain version == the Pallas ``roi_pool_patches_flat`` in
    interpret mode on identical inputs.  float32, dense random hats: atol
    2e-5, as the JAX package's own interpret-mode tests use.  bfloat16, the
    pooler's own inputs (real boxes, narrow hat spans): EQUAL, because both
    round the hats and ``A_y . window`` to bf16 and accumulate in float32;
    before the port rounded as the TPU kernel does, 60% of these outputs
    differed."""
    from treedetection_tpu.ops.pallas.roi_align_kernel import (
        roi_pool_patches_flat as pallas_pool)
    patch = 48
    if dtype == "float32":
        rng = np.random.default_rng(resolution)
        n, c = 16, 8
        fcat = rng.standard_normal((200, 120, c)).astype(np.float32)
        rows = rng.integers(0, 200 - patch, n).astype(np.int32)
        cols = (rng.integers(0, (120 - patch - 8) // 8 + 1, n) * 8).astype(
            np.int32)
        ay = rng.uniform(0, 0.5, (n, resolution, patch)).astype(np.float32)
        ax = rng.uniform(0, 0.5, (n, resolution, patch + 8)).astype(
            np.float32)
        args = [torch.from_numpy(a) for a in (fcat, rows, cols, ay, ax)]
    else:
        args = _crown_flat_inputs(resolution, 40 + resolution)
    n = args[1].shape[0]
    jargs = [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
             if a.dtype == torch.bfloat16 else jnp.asarray(a.numpy())
             for a in args]
    want = np.asarray(pallas_pool(*jargs, resolution, patch, n,
                                  interpret=True).astype(jnp.float32))
    got = roi_pool_patches_flat_reference(*args, resolution, patch, chunk=5)
    assert got.dtype == args[0].dtype
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    else:
        np.testing.assert_array_equal(got.float().numpy(), want)
        assert np.abs(want).max() > 0.5
    # the wrapper takes the plain version for CPU tensors, without a launch
    from treedetection_tpu_torch.build import launch_counts
    before = launch_counts()["k1"]
    assert torch.equal(roi_pool_patches_flat(*args, resolution, patch), got)
    assert launch_counts()["k1"] == before


def test_hat_spans_match_numpy():
    """``hat_spans`` == the first and last nonzero row of ``ay`` and column
    of ``ax`` found with numpy, on the pooler's hats and on crafted ones: a
    full span, a one-row span, spans at row 47 and column 55, and boxes
    with all-zero hats (the empty span [0, -1, 0, -1])."""
    _, _, _, ay, ax = _crown_flat_inputs(7, 3)
    ay, ax = ay.clone(), ax.clone()
    ay[0], ax[0] = 0.5, 0.5
    ay[1] = 0
    ay[1, 3, 20] = 0.25
    ay[2], ax[2] = 0, 0
    ay[2, :, 47], ax[2, 6, 55] = 0.5, 1.0
    ay[3] = 0
    ax[4] = 0
    got = hat_spans(ay, ax).numpy()
    for i, (a, b) in enumerate(zip(ay.numpy(), ax.numpy())):
        ys, xs = np.nonzero(a.any(axis=0))[0], np.nonzero(b.any(axis=0))[0]
        want = ([ys[0], ys[-1], xs[0], xs[-1]] if len(ys) and len(xs)
                else [0, -1, 0, -1])
        assert got[i].tolist() == want, i
    assert got[:5].tolist() == [[0, 47, 0, 55], got[1].tolist(),
                                [47, 47, 55, 55], [0, -1, 0, -1],
                                [0, -1, 0, -1]]
    assert got[1, :2].tolist() == [20, 20]
    spans = got[5:]
    assert (spans[:, 1] - spans[:, 0]).max() < 30   # narrow, as real crowns
    assert hat_spans(ay[:0], ax[:0]).shape == (0, 4)


def test_k1_wrapper_rejects_bad_inputs():
    n, r = 4, 7
    fcat = torch.zeros(100, 80, 8)
    rows = torch.zeros(n, dtype=torch.int32)
    cols = torch.full((n,), 8, dtype=torch.int32)
    ay, ax = torch.zeros(n, r, 48), torch.zeros(n, r, 56)
    roi_pool_patches_flat(fcat, rows, cols, ay, ax, r)
    with pytest.raises(ValueError, match="multiples of 8"):
        roi_pool_patches_flat(fcat, rows, cols + 3, ay, ax, r)
    with pytest.raises(TypeError):
        roi_pool_patches_flat(fcat.double(), rows, cols, ay, ax, r)
    with pytest.raises(ValueError):
        roi_pool_patches_flat(fcat, rows.long(), cols, ay, ax, r)
    with pytest.raises(ValueError):
        roi_pool_patches_flat(fcat, rows, cols, ax, ax, r)
    with pytest.raises(ValueError, match="contiguous"):
        roi_pool_patches_flat(fcat.transpose(0, 1).contiguous().transpose(
            0, 1), rows, cols, ay, ax, r)


def _mixed_boxes(rng, n_small=18, n_large=3, n_strips=3, img=256.0):
    """One image's boxes across the pooling classes: small crowns, large
    boxes (25-28 cells on P2, still inside the 48-row patch), and aspect-12.8
    strips that outspan the patch (the gather tail serves the first
    ``exact_budget`` of them, the rest stay flagged)."""
    rows = []
    for _ in range(n_small):
        cx, cy = rng.uniform(40, 216, 2)
        s = rng.uniform(20, 60)
        rows.append([cx - s / 2, cy - s / 2, cx + s / 2, cy + s / 2])
    for _ in range(n_large):
        cx, cy = rng.uniform(60, 196, 2)
        s = rng.uniform(100, 110)
        rows.append([cx - s / 2, cy - s / 2, cx + s / 2, cy + s / 2])
    for _ in range(n_strips):
        y = rng.uniform(40, 200)
        rows.append([0.0, y, img, y + 20.0])
    return np.clip(np.asarray(rows, dtype=np.float32), 0, img)


@pytest.mark.parametrize("resolution", [7, 14])
def test_multilevel_roi_align_batched_matches_jax(resolution):
    """The port's flat batched pooler == JAX's (Pallas in interpret mode):
    features within 2e-5 (the two float32 contractions sum in different
    orders) and the (B, N) inexact mask exactly — with three strips per
    image and a two-box exact budget, one strip per image stays flagged."""
    from treedetection_tpu.ops.roi_align import (
        multilevel_roi_align_batched as jax_pool)
    rng = np.random.default_rng(30 + resolution)
    c = 8
    fmaps = [rng.standard_normal((2, 64 >> i, 64 >> i, c)).astype(np.float32)
             for i in range(4)]
    boxes = np.stack([_mixed_boxes(rng) for _ in range(2)])
    strides = (4, 8, 16, 32)
    # one compiled computation: called eagerly, the interpreted kernel's
    # host callbacks race the main thread's dispatch of the ops after it
    want, want_mask = jax.block_until_ready(jax.jit(
        lambda f, bx: jax_pool(f, bx, resolution, strides, pallas=True,
                               force_interpret=True,
                               return_inexact_mask=True))(
        [jnp.asarray(f) for f in fmaps], jnp.asarray(boxes)))
    got, got_mask = multilevel_roi_align_batched(
        [torch.from_numpy(f) for f in fmaps], torch.from_numpy(boxes),
        resolution, strides)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert got_mask.numpy().sum(axis=1).tolist() == [1, 1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)
