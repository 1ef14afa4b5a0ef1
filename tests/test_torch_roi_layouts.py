"""The ROI pooler's three layouts and its single-image form against the JAX
package's, on the CPU in float32.

The JAX side runs its Pallas kernels in interpret mode (``interpret=True`` /
``force_interpret=True``), as its own tests in ``tests/test_ops.py`` do; the
port's wrappers take their plain versions because the tensors lie on the
CPU.  Inputs are made with numpy from a seed: levels 64^2..8^2, C=16, B=2,
N=24 (the JAX tests' sizes).  Tolerance: atol 2e-5 in float32, the JAX
tests' own (two float32 contractions summed in different orders); in
bfloat16 the outputs must be EQUAL (both packages round the hats and
``A_y . window`` to bf16 and accumulate in float32); inexact masks and
overflow counts must be EQUAL.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from treedetection_tpu_torch.ops import roi_align as port  # noqa: E402
from treedetection_tpu_torch.ops.kernels import roi_align as kernels  # noqa: E402

STRIDES = (4, 8, 16, 32)
ATOL = 2e-5
LAYOUT_VARS = ("TD_ROI_FLAT", "TD_ROI_RESIDENT", "TD_ROI_SMALL",
               "TD_ROI_LARGE_FRAC", "TD_ROI_EXACT_FRAC", "TD_ROI_VMEM_MB",
               "TD_ROI_CHUNK", "TD_ROI_SLOTS")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in LAYOUT_VARS:
        monkeypatch.delenv(name, raising=False)


def _fmaps(seed, batch=2, base=64, c=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, base >> i, base >> i, c)).astype(
        np.float32) for i in range(4)]


# (resolution, feature dtype) of the kernel-level cases; the ids keep the
# float32 cases' names of before the bfloat16 cases
KERNEL_CASES = dict(argnames="resolution,dtype", argvalues=[
    (7, torch.float32), (14, torch.float32), (7, torch.bfloat16),
    (14, torch.bfloat16)], ids=["7", "14", "bf16-7", "bf16-14"])


def _assert_matches(got, want):
    """float32: atol 2e-5; bfloat16: equal."""
    if got.dtype == torch.bfloat16:
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def _mixed_boxes(strips=True, n_small=18):
    """(2, N) boxes across the patch classes, as ``tests/test_ops.py``
    ``_batched_mixed_boxes``: small (20-60 px), large (100-110 px: 25-28
    cells on P2) and, with ``strips``, one aspect-12.8 strip per image that
    outspans even the 48-row patch."""
    rng = np.random.default_rng(30)
    imgs = []
    for _ in range(2):
        rows = []
        for _ in range(n_small):
            cx, cy = rng.uniform(40, 216, 2)
            s = rng.uniform(20, 60)
            rows.append([cx - s / 2, cy - s / 2, cx + s / 2, cy + s / 2])
        for _ in range(5 if strips else 6):
            cx, cy = rng.uniform(60, 196, 2)
            s = rng.uniform(100, 110)
            rows.append([cx - s / 2, cy - s / 2, cx + s / 2, cy + s / 2])
        if strips:
            y = rng.uniform(40, 200)
            rows.append([0.0, y, 256.0, y + 20.0])
        imgs.append(np.clip(np.asarray(rows, dtype=np.float32), 0, 256))
    return np.stack(imgs)


def _edge_boxes(n=26, seed=3):
    """(2, n) boxes that reach the bottom/right edge and the top level, so
    that the resident layout's clamp moves their origins."""
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(0, 256, (2, n, 2))
    wh = rng.uniform(8, 250, (2, n, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
    boxes[:, :4] = [[180, 190, 256, 256], [0, 0, 256, 256],
                    [200, 10, 256, 120], [10, 200, 120, 256]]
    return np.clip(boxes, 0, 256).astype(np.float32)


def _corner_boxes(img=512.0):
    """(2, 16) boxes at each image's four corners, 12 to 480 px: windows on
    all four levels that reach the right and bottom edges of the level's
    features (into the buffer's padding)."""
    rows = []
    for s in (12.0, 120.0, 250.0, 480.0):
        for x, y in ((0, 0), (img - s, 0), (0, img - s), (img - s, img - s)):
            rows.append([x, y, x + s, y + s])
    boxes = np.asarray(rows, dtype=np.float32)
    return np.stack([boxes, boxes[::-1].copy()])


def _all_level_boxes(n=30, seed=4, img=512.0):
    """(2, n) boxes of 8 to 512 px over a 512 px image, the first of each
    image large enough for the top level: every level."""
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(0, img, (2, n, 2))
    side = np.exp(rng.uniform(np.log(8), np.log(img), (2, n, 1)))
    boxes = np.concatenate([ctr - side / 2, ctr + side / 2], -1)
    boxes[:, 0] = [[16.0, 24.0, 496.0, 500.0], [0.0, 40.0, 470.0, 512.0]]
    return np.clip(boxes, 0, img).astype(np.float32)


# geometry -> (boxes, feature map side of level 0): the K5 cases
K5_GEOMETRIES = {"edge": (_edge_boxes, 64), "corners": (_corner_boxes, 128),
                 "zero_hats": (_edge_boxes, 64),
                 "all_levels": (_all_level_boxes, 128)}


def _jitted(fn, *args):
    """Run a JAX pooler as ONE compiled computation and wait for it.  Called
    eagerly, the interpreted Pallas kernel's host callbacks run on runtime
    threads while the main thread goes on dispatching the ops that follow
    the kernel (top-k, the gather tail); on a loaded machine the two can
    wait for each other forever.  The environment variables are read while
    tracing, so ``monkeypatch.setenv`` acts as in an eager call."""
    return jax.block_until_ready(jax.jit(fn)(*args))


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jnp(tensors):
    """Tensors -> JAX arrays of the same dtype (bfloat16 through float32,
    which both round alike)."""
    return tuple(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                 if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy())
                 for t in tensors)


# --- kernel level ---------------------------------------------------------------

@pytest.mark.parametrize(
    "resolution,dtype,geometry",
    [(7, torch.float32, "edge"), (14, torch.float32, "edge"),
     (7, torch.bfloat16, "edge"), (14, torch.bfloat16, "edge")]
    + [(r, torch.bfloat16, g) for g in ("corners", "zero_hats", "all_levels")
       for r in (7, 14)],
    ids=["7", "14", "bf16-7", "bf16-14"]
    + [f"bf16-{r}-{g}" for g in ("corners", "zero_hats", "all_levels")
       for r in (7, 14)])
def test_k5_plain_matches_pallas_interpret(resolution, dtype, geometry):
    """K5's plain version == the Pallas ``roi_pool_patches`` in interpret
    mode on the same buffers, ``meta`` and hats (the pooler's own: real
    boxes, bilinear hats), in float32 and in bfloat16; the wrapper takes the
    plain version for CPU tensors without a launch.  In bfloat16 also:
    windows at every level's right and bottom edge (``corners``), boxes with
    all-zero hats (``zero_hats``), boxes on all four levels in one call
    (``all_levels``)."""
    from treedetection_tpu.ops.pallas import roi_align_kernel as rk
    make_boxes, side = K5_GEOMETRIES[geometry]
    fmaps = [f.to(dtype) for f in _torch(_fmaps(50 + resolution, base=side))]
    p = port.level_pool_inputs(fmaps, torch.from_numpy(make_boxes()),
                               resolution, STRIDES)
    n = p.meta.shape[0]
    levels = p.meta[:, 0].long()
    if geometry in ("corners", "all_levels"):
        assert sorted(set(levels.tolist())) == [0, 1, 2, 3]
    if geometry == "corners":
        # windows reach past each level's features on the right and at the
        # bottom of the last image's section, the buffer's last rows
        hs = torch.tensor(p.geom.hs)[levels]
        ws = torch.tensor(p.geom.ws)[levels]
        row_in_image = p.meta[:, 1].long() - (n // 2 <= torch.arange(n)) \
            * (hs + 48)
        for lvl in range(4):
            on = levels == lvl
            assert bool((p.meta[on, 2] + 56 > ws[on]).any())
            assert bool((row_in_image[on] + 48 > hs[on]).any())
    if geometry == "zero_hats":
        dead = torch.arange(n) % 5 == 0
        p.geom.ay[dead] = 0.0
        p.geom.ax[torch.arange(n) % 7 == 3] = 0.0
    want = np.asarray(_jitted(
        lambda f, m, a, b: rk.roi_pool_patches(f, m, a, b, resolution, 48, n,
                                               interpret=True),
        _jnp(p.kpadded), *_jnp((p.meta, p.ay, p.ax))).astype(jnp.float32))
    got = kernels.roi_pool_patches_reference(p.kpadded, p.meta, p.ay, p.ax,
                                             resolution)
    _assert_matches(got, want)
    assert np.abs(want).max() > 0.1
    if geometry == "zero_hats":
        assert float(got[dead].float().abs().max()) == 0.0
    before = kernels.launches_patches
    assert torch.equal(kernels.roi_pool_patches(p.kpadded, p.meta, p.ay, p.ax,
                                                resolution), got)
    assert kernels.launches_patches == before


@pytest.mark.parametrize("c_split", [1, 2])
@pytest.mark.parametrize(**KERNEL_CASES)
def test_k6_plain_matches_pallas_interpret(resolution, dtype, c_split):
    """K6's plain version == the Pallas ``roi_pool_resident`` in interpret
    mode at whole C and at two C-blocks, on the port's resident inputs:
    clamped image-relative origins, refolded hats, each image's 26 boxes
    padded to 30 (chunk 5); in float32 and in bfloat16."""
    from treedetection_tpu.ops.pallas import roi_align_kernel as rk
    fmaps = [f.to(dtype) for f in _torch(_fmaps(60 + resolution))]
    p = port.level_pool_inputs(fmaps, torch.from_numpy(_edge_boxes()),
                               resolution, STRIDES)
    r = port.resident_pool_inputs(p, resolution, 2, n_images=2, chunk=5,
                                  c_split=c_split)
    assert r.pad_per == 4 and r.meta.shape[0] == 60
    # the clamp moved some origins: the hats differ from the per-level ones
    assert not torch.equal(r.ay.reshape(2, 30, -1)[:, :26],
                           p.ay.reshape(2, 26, -1))
    want = np.asarray(_jitted(
        lambda f, m, a, b: rk.roi_pool_resident(
            f, m, a, b, resolution, 48, r.chunk, 2, c_split, interpret=True),
        _jnp(r.kpadded), *_jnp((r.meta, r.ay, r.ax))).astype(jnp.float32))
    got = kernels.roi_pool_resident_reference(
        r.kpadded, r.meta, r.ay, r.ax, resolution, 48, r.chunk, 2, c_split)
    _assert_matches(got, want)
    assert np.abs(want).max() > 0.1
    # padding boxes (zero hats, meta 0) pool to zeros
    assert float(got.reshape(2, 30, -1)[:, 26:].abs().max()) == 0.0
    before = kernels.launches_resident
    assert torch.equal(kernels.roi_pool_resident(
        r.kpadded, r.meta, r.ay, r.ax, resolution, 48, r.chunk, 2, c_split),
        got)
    assert kernels.launches_resident == before


def test_k5_k6_wrappers_reject_bad_inputs():
    p = port.level_pool_inputs(_torch(_fmaps(1)),
                               torch.from_numpy(_edge_boxes(n=8)), 7, STRIDES)
    r = port.resident_pool_inputs(p, 7, 2, n_images=2, chunk=4, c_split=1)
    bad = p.meta.clone()
    bad[0, 0] = 4
    with pytest.raises(ValueError, match="level"):
        kernels.roi_pool_patches(p.kpadded, bad, p.ay, p.ax, 7)
    bad = p.meta.clone()
    bad[0, 2] += 3
    with pytest.raises(ValueError, match="multiples of 8"):
        kernels.roi_pool_patches(p.kpadded, bad, p.ay, p.ax, 7)
    with pytest.raises(ValueError, match="one dtype and C"):
        kernels.roi_pool_patches(
            (p.kpadded[0].double().float()[..., :8].contiguous(),)
            + p.kpadded[1:], p.meta, p.ay, p.ax, 7)
    with pytest.raises(ValueError, match="level buffers"):
        kernels.roi_pool_patches(p.kpadded + p.kpadded[:1], p.meta, p.ay,
                                 p.ax, 7)
    with pytest.raises(TypeError):
        kernels.roi_pool_patches(tuple(k.double() for k in p.kpadded), p.meta,
                                 p.ay, p.ax, 7)
    args = (r.meta, r.ay, r.ax, 7, 48)
    with pytest.raises(ValueError, match="multiple of chunk"):
        kernels.roi_pool_resident(r.kpadded, *args, 3, 2, 1)
    with pytest.raises(ValueError, match="blocks"):
        kernels.roi_pool_resident(r.kpadded, *args, 4, 2, 3)
    with pytest.raises(ValueError, match="images"):
        kernels.roi_pool_resident(r.kpadded, *args, 4, 3, 1)
    # the per-level meta carries the image's row base and unclamped origins
    with pytest.raises(ValueError, match="clamped"):
        kernels.roi_pool_resident(p.kpadded, p.meta, p.ay, p.ax, 7, 48, 4, 2)


def test_resident_section_bytes_and_c_split_rule(monkeypatch):
    """``resident_section_bytes`` is the JAX ``resident_vmem_bytes``; at the
    example geometry (1024^2 input, C=256) one image's sections are 45.4 MB
    in bf16, so half of a 50 MB L2 takes c_split=2 (4 in float32); when no
    split fits the launcher raises."""
    from treedetection_tpu.ops.pallas.roi_align_kernel import (
        resident_vmem_bytes)
    for hs, ws, c_blk, item in (([64, 32, 16, 8], [64, 32, 16, 8], 16, 4),
                                ([256, 128, 64, 32], [256, 128, 64, 32], 128,
                                 2)):
        assert kernels.resident_section_bytes(hs, ws, c_blk, 48, item) == \
            resident_vmem_bytes(hs, ws, c_blk, 48, item)
    sizes = [256, 128, 64, 32]
    assert kernels.resident_section_bytes(sizes, sizes, 256, 48, 2) == \
        88704 * 256 * 2 == 45416448

    def buffers(dtype, c=256, n_images=3):
        return [torch.empty((n_images * (s + 48), s + 56, c), dtype=dtype,
                            device="meta") for s in sizes]

    assert kernels.resident_l2_budget(torch.device("cpu")) == 25 * 2 ** 20
    assert port.resident_c_split(buffers(torch.bfloat16), 3) == 2
    assert port.resident_c_split(buffers(torch.float32), 3) == 4
    monkeypatch.setattr(kernels, "RESIDENT_L2_SHARE", 1.0)
    assert port.resident_c_split(buffers(torch.bfloat16), 3) == 1
    monkeypatch.setattr(kernels, "RESIDENT_L2_SHARE", 1e-6)
    with pytest.raises(RuntimeError, match="no C-split"):
        port.resident_c_split(buffers(torch.bfloat16), 3)


def _crowns_1024(rng, b, n, img=1024.0):
    """(b, n) crown-like boxes over a 1024 px image, as ``chip_smoke.py``'s
    kernel phase draws them: 16-200 px, aspect up to 2."""
    c = rng.uniform(0, img, (b, n, 2))
    s = rng.uniform(16, 200, (b, n, 1))
    asp = rng.uniform(0.5, 2.0, (b, n, 1))
    wh = s * [1.0, 1.0] * (asp ** [0.5, -0.5])
    boxes = np.concatenate([c - wh / 2, c + wh / 2], axis=-1)
    return np.clip(boxes, 0, img).astype(np.float32)


@pytest.mark.parametrize("resolution", [7, 14])
def test_resident_hats_are_the_level_hats_shifted_by_the_clamp(resolution):
    """What makes bf16 K6 give K1's bits: for every box, the hats that
    ``resident_pool_inputs`` folds for its clamped origin, shifted back by
    the clamp, equal ``level_pool_inputs``' hats bit for bit, and none of
    their weight lies in the columns the shift brings in.  On crown boxes
    at 1024^2 (two images of 256), where the clamp moves windows on both
    axes."""
    b, n = 2, 256
    boxes = torch.from_numpy(_crowns_1024(np.random.default_rng(resolution),
                                          b, n))
    fmaps = [torch.zeros((b, 1024 // s, 1024 // s, 8)) for s in STRIDES]
    p = port.level_pool_inputs(fmaps, boxes, resolution, STRIDES)
    r = port.resident_pool_inputs(p, resolution, 2, n_images=b, chunk=1,
                                  c_split=1)
    assert r.pad_per == 0 and torch.equal(r.meta[:, 0], p.meta[:, 0])
    src_h = torch.tensor([f.shape[0] // b for f in p.kpadded])
    image = torch.arange(b * n) // n
    level = p.meta[:, 0].long()
    dy = (p.meta[:, 1] - image * src_h[level] - r.meta[:, 1]).long()
    dx = (p.meta[:, 2] - r.meta[:, 2]).long()
    assert (dy >= 0).all() and (dx >= 0).all()
    assert int((dy > 0).sum()) > 10 and int((dx > 0).sum()) > 10
    for resident, per_level, shift in ((r.ay, p.ay, dy), (r.ax, p.ax, dx)):
        width = resident.shape[-1]
        col = torch.arange(width)[None, :] + shift[:, None]
        back = torch.gather(resident, 2, col.clamp(max=width - 1)[:, None, :]
                            .expand_as(resident))
        back = torch.where((col < width)[:, None, :], back, 0.0)
        assert torch.equal(back, per_level)
        brought_in = (torch.arange(width)[None, :] < shift[:, None])
        assert not resident[brought_in[:, None, :].expand_as(resident)].any()
    assert float(p.ay.abs().max()) > 0 and float(p.ax.abs().max()) > 0


# --- pooler level -----------------------------------------------------------------

# name -> (environment, strips in the boxes, expected per-image overflow)
POOLER_CASES = {
    "levels": ({"TD_ROI_FLAT": "0"}, True, [0, 0]),
    "resident_whole": ({"TD_ROI_RESIDENT": "1"}, True, [0, 0]),
    "resident_split": ({"TD_ROI_RESIDENT": "1"}, True, [0, 0]),
    "overlay": ({"TD_ROI_SMALL": "16", "TD_ROI_LARGE_FRAC": "0.5"}, True,
                [0, 0]),
    "overlay_levels": ({"TD_ROI_FLAT": "0", "TD_ROI_SMALL": "16",
                        "TD_ROI_LARGE_FRAC": "0.5"}, True, [0, 0]),
    "beyond_budget": ({"TD_ROI_SMALL": "24", "TD_ROI_LARGE_FRAC": "0.05",
                       "TD_ROI_EXACT_FRAC": "0"}, False, [4, 4]),
    "exact_tail": ({"TD_ROI_SMALL": "16", "TD_ROI_LARGE_FRAC": "0.5",
                    "TD_ROI_EXACT_FRAC": "0.25"}, True, [0, 0]),
    "per_image_budgets": ({"TD_ROI_SMALL": "24", "TD_ROI_LARGE_FRAC": "0.05",
                           "TD_ROI_EXACT_FRAC": "0"}, False, [4, 0]),
    "small_resident_set": ({"TD_ROI_RESIDENT": "1", "TD_ROI_SMALL": "16",
                            "TD_ROI_LARGE_FRAC": "0.5"}, True, [0, 0]),
    # bfloat16 features; no strip, so the float32 gather tail takes no box
    "flat_bf16": ({}, False, [0, 0]),
    "resident_bf16": ({"TD_ROI_RESIDENT": "1"}, False, [0, 0]),
}


def _force_split(monkeypatch, fmaps):
    """Budgets below the whole-C sections and above the half-C ones, on both
    sides: the port's L2 share, the JAX launcher's TD_ROI_VMEM_MB."""
    sizes = [f.shape[1] for f in fmaps]
    c = fmaps[0].shape[-1]
    full = kernels.resident_section_bytes(sizes, sizes, c, 48, 4)
    monkeypatch.setattr(kernels, "RESIDENT_L2_SHARE",
                        0.75 * full / kernels.H100_L2_BYTES)
    monkeypatch.setenv("TD_ROI_VMEM_MB",
                       str((full * 0.75 + (32 << 20)) / (1 << 20)))


@pytest.mark.parametrize("case", sorted(POOLER_CASES))
def test_batched_pooler_layouts_match_jax(monkeypatch, case):
    """``multilevel_roi_align_batched`` under each layout and class setting
    against the JAX function under the same variables: features within 2e-5
    (equal for the bfloat16 cases), the (B, N) inexact mask equal, the
    per-image counts as ``tests/test_ops.py`` pins them."""
    from treedetection_tpu.ops.roi_align import (
        multilevel_roi_align_batched as jax_pool)
    env, strips, expected = POOLER_CASES[case]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    fmaps = _fmaps(31 + len(case))
    boxes = _mixed_boxes(strips=strips)
    if case == "per_image_budgets":
        for i in range(18, 22):     # image 1 keeps only 2 large boxes
            x0, y0 = boxes[1, i, 0], boxes[1, i, 1]
            boxes[1, i] = [x0, y0, x0 + 40, y0 + 40]
    splits = []
    if case.startswith("resident"):
        if case == "resident_split":
            _force_split(monkeypatch, fmaps)
        real = port.roi_pool_resident

        def spy(*args):
            splits.append(args[-1])
            return real(*args)
        monkeypatch.setattr(port, "roi_pool_resident", spy)
    tfmaps = _torch(fmaps)
    if case.endswith("bf16"):
        tfmaps = [f.to(torch.bfloat16) for f in tfmaps]
    want, want_mask = _jitted(
        lambda f, bx: jax_pool(f, bx, 7, STRIDES, pallas=True,
                               force_interpret=True,
                               return_inexact_mask=True),
        list(_jnp(tfmaps)), jnp.asarray(boxes))
    got, got_mask = port.multilevel_roi_align_batched(
        tfmaps, torch.from_numpy(boxes), 7, STRIDES)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert got_mask.sum(dim=1).tolist() == expected
    assert got.dtype == tfmaps[0].dtype
    _assert_matches(got, np.asarray(want.astype(jnp.float32)))
    if case.startswith("resident"):
        assert splits == [2 if case == "resident_split" else 1]


@pytest.mark.parametrize("resolution", [7, 14])
def test_layouts_agree_and_default_is_unchanged(monkeypatch, resolution):
    """The three layouts give the same features within 2e-5 and the same
    inexact mask on the same inputs (edge boxes: the resident clamp is
    active); and the default layout's output is bit-equal to the flat
    pooling written out here from ``flat_pool_inputs`` and K1's plain
    version (one launch, then the exact tail)."""
    fmaps = _torch(_fmaps(70 + resolution))
    boxes = torch.from_numpy(_edge_boxes())
    boxes[:, 4:8] = torch.tensor([[0.0, 50, 256, 70]])    # four strips
    out_flat, inexact_flat = port.multilevel_roi_align_batched(
        fmaps, boxes, resolution, STRIDES)
    monkeypatch.setenv("TD_ROI_FLAT", "0")
    out_lvl, inexact_lvl = port.multilevel_roi_align_batched(
        fmaps, boxes, resolution, STRIDES)
    monkeypatch.setenv("TD_ROI_RESIDENT", "1")
    out_res, inexact_res = port.multilevel_roi_align_batched(
        fmaps, boxes, resolution, STRIDES)
    for out, inexact in ((out_lvl, inexact_lvl), (out_res, inexact_res)):
        assert torch.equal(inexact, inexact_flat)
        np.testing.assert_allclose(out.numpy(), out_flat.numpy(), rtol=0,
                                   atol=ATOL)
    with pytest.raises(ValueError, match="flat layout"):
        port.multilevel_roi_align_batched(
            fmaps, boxes, resolution, STRIDES,
            pool=kernels.roi_pool_patches_flat_reference)

    # the default layout, written out
    b, n, c = 2, boxes.shape[1], 16
    p = port.flat_pool_inputs(fmaps, boxes, resolution, STRIDES)
    g = p.geom
    want = kernels.roi_pool_patches_flat_reference(p.kcat, p.rows, p.cols,
                                                   p.ay, p.ax, resolution)
    m = int(np.ceil(n * (0.05 if resolution == 7 else 0.08)))
    flag, idx = port.stable_topk(
        g.overflow.reshape(b, n).to(torch.float32) * 2.0, m)
    sel = (torch.arange(b)[:, None] * n + idx).reshape(-1)
    take = (flag > 0).reshape(-1)
    wmax = p.kcat.shape[1]
    exact = port._gather_rows_core(
        p.kcat.reshape(-1, c), p.lvl_base * wmax, np.full(4, wmax), g.hs,
        g.ws, g.flat_boxes[sel], g.levels[sel], g.img[sel], resolution,
        STRIDES, 2)
    want[sel] = torch.where(take[:, None, None, None], exact, want[sel])
    assert torch.equal(out_flat.reshape(want.shape), want)
    assert torch.equal(inexact_flat.reshape(-1),
                       g.overflow & ~torch.zeros(b * n, dtype=torch.bool)
                       .index_put((sel,), take))
    assert int(inexact_flat.sum()) == (4 if resolution == 7 else 2)


# --- single image -----------------------------------------------------------------

def _single_boxes(n, seed, img=256, max_aspect=2.0):
    rng = np.random.default_rng(seed)
    cx, cy = rng.uniform(0, img, n), rng.uniform(0, img, n)
    size = rng.uniform(8, img / 2, n)
    aspect = rng.uniform(1 / max_aspect, max_aspect, n)
    w, h = size * np.sqrt(aspect), size / np.sqrt(aspect)
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], 1)
    return np.clip(boxes, 0, img).astype(np.float32)


@pytest.mark.parametrize("resolution,n_strips,overflow", [(7, 1, 0),
                                                          (14, 0, 0),
                                                          (7, 18, 2)])
def test_single_image_pooler_matches_jax(resolution, n_strips, overflow):
    """``multilevel_roi_align`` (K5 on one image's padded maps + the
    16-box gather fix-up) == the JAX function with its Pallas kernel in
    interpret mode, features and overflow count: with one strip the
    fallback serves it, with 18 strips two stay truncated."""
    from treedetection_tpu.ops.roi_align import (
        multilevel_roi_align as jax_pool)
    fmaps = [f[0] for f in _fmaps(13 + resolution, batch=1)]
    boxes = _single_boxes(40, 14 + resolution)
    rng = np.random.default_rng(n_strips)
    for i in range(n_strips):
        y = rng.uniform(20, 220)
        boxes[2 * i] = [0.0, y, 256.0, y + 20.0]
    want, want_over = _jitted(
        lambda f, bx: jax_pool(f, bx, resolution, STRIDES, pallas=True,
                               force_interpret=True, return_overflow=True),
        [jnp.asarray(f) for f in fmaps], jnp.asarray(boxes))
    got, got_over = port.multilevel_roi_align(
        _torch(fmaps), torch.from_numpy(boxes), resolution, STRIDES,
        return_overflow=True)
    assert int(got_over) == int(want_over) == overflow
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    plain = port.multilevel_roi_align(_torch(fmaps), torch.from_numpy(boxes),
                                      resolution, STRIDES)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("resolution", [7, 14])
def test_gather_oracle_matches_jax(resolution):
    """``multilevel_roi_align_gather`` == the JAX oracle (atol 2e-5: the
    four-corner blend rounds in another order under XLA), and the patch
    pooler agrees with it on boxes that fit the patch."""
    from treedetection_tpu.ops.roi_align import (
        multilevel_roi_align_gather as jax_gather)
    fmaps = [f[0] for f in _fmaps(15 + resolution, batch=1)]
    boxes = _single_boxes(50, 16 + resolution)
    boxes[0] = [0.0, 100.0, 256.0, 120.0]
    want = np.asarray(jax_gather([jnp.asarray(f) for f in fmaps],
                                 jnp.asarray(boxes), resolution, STRIDES))
    got = port.multilevel_roi_align_gather(
        _torch(fmaps), torch.from_numpy(boxes), resolution, STRIDES)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    fast = port.multilevel_roi_align(_torch(fmaps), torch.from_numpy(boxes),
                                     resolution, STRIDES)
    np.testing.assert_allclose(fast.numpy(), got.numpy(), rtol=0, atol=ATOL)


def test_large_geometry_pools_through_the_gather_path():
    """An input whose top level exceeds the patch span (2048 px at stride
    32: 64 cells > 46) pools every box through the gather path, in the
    batched and the single-image pooler, with nothing flagged."""
    rng = np.random.default_rng(2)
    fmaps = [rng.standard_normal((1, 512 >> i, 512 >> i, 2)).astype(
        np.float32) for i in range(4)]
    boxes = (_single_boxes(6, 4, img=2048))[None]
    out, inexact = port.multilevel_roi_align_batched(
        _torch(fmaps), torch.from_numpy(boxes), 7, STRIDES)
    one, over = port.multilevel_roi_align(
        [f[0] for f in _torch(fmaps)], torch.from_numpy(boxes[0]), 7, STRIDES,
        return_overflow=True)
    oracle = port.multilevel_roi_align_gather(
        [f[0] for f in _torch(fmaps)], torch.from_numpy(boxes[0]), 7, STRIDES)
    assert not inexact.any() and int(over) == 0
    np.testing.assert_allclose(out[0].numpy(), oracle.numpy(), atol=1e-6)
    assert torch.equal(one, oracle)
