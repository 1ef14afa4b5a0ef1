"""The batched ROI pooler's level tables, geometry and exact tail on the CPU.

On the card the geometry and the exact tail are two kernels
(``csrc/roi_pool_prep.cu``) fed by level tables kept on the device; a tensor
on the CPU takes their plain versions.  These tests hold the plain versions
to the pooler as it was before the kernels (its geometry built from host
constants copied at every call, its exact tail a gather and a ``torch.where``
scatter), written out below, bit for bit under all three layouts; and the
table cache to one copy per key.  The kernels themselves run only on the
card (``tests/test_torch_kernels.py``, ``chip_smoke.py``'s kernel phase).
"""

import threading
import time

import numpy as np
import pytest
import torch

from treedetection_tpu_torch import build
from treedetection_tpu_torch.build import launch_counts
from treedetection_tpu_torch.models.mask_rcnn import MaskRCNN, MaskRCNNConfig
from treedetection_tpu_torch.ops import roi_align as port
from treedetection_tpu_torch.ops.kernels import frozen_norm, relpos_attention
from treedetection_tpu_torch.ops.kernels import roi_align as kernels

STRIDES = (4, 8, 16, 32)
HS = np.array([64, 32, 16, 8])
LAYOUT_VARS = ("TD_ROI_FLAT", "TD_ROI_RESIDENT", "TD_ROI_SMALL",
               "TD_ROI_LARGE_FRAC", "TD_ROI_EXACT_FRAC")
LAYOUT_ENV = {"flat": {}, "levels": {"TD_ROI_FLAT": "0"},
              "resident": {"TD_ROI_RESIDENT": "1"}}


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in LAYOUT_VARS:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture()
def copies(monkeypatch):
    """A fresh table cache, and the host-to-device copies counted."""
    monkeypatch.setattr(port, "_TABLES", {})
    made = []
    real = port._h2d

    def counted(make, values, **kwargs):
        made.append(np.asarray(values).copy())
        return real(make, values, **kwargs)

    monkeypatch.setattr(port, "_h2d", counted)
    return made


def _fmaps(seed, batch=2, base=64, c=16):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(
        (batch, base >> i, base >> i, c)).astype(np.float32))
        for i in range(4)]


def _boxes(seed=3, n=26):
    """(2, n) boxes on a 256 px image: edges, every level, zero-area boxes,
    boxes reaching off the image and strips that outspan the 48-row patch
    (so the exact tail has work and budget to spare)."""
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(0, 256, (2, n, 2))
    wh = rng.uniform(8, 250, (2, n, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
    boxes[:, :4] = [[180, 190, 256, 256], [0, 0, 256, 256],
                    [200, 10, 256, 120], [10, 200, 120, 256]]
    boxes = np.clip(boxes, 0, 256)
    boxes[:, 4] = [0.0, 50.0, 256.0, 70.0]          # strips
    boxes[0, 5] = [0.0, 120.0, 256.0, 131.0]
    boxes[:, 8] = [0.0, 160.0, 250.0, 175.0]
    boxes[:, 9] = [20.0, 0.0, 35.0, 256.0]
    boxes[:, 6] = [30.0, 30.0, 30.0, 90.0]          # zero area
    boxes[:, 7] = [-40.0, 230.0, 60.0, 300.0]       # off the image
    return torch.from_numpy(boxes.astype(np.float32))


# --- the pooler before the kernels, written out ---------------------------------

def _before_prep(flat_boxes, hs, ws, resolution, s):
    """Per-box geometry from host constants copied at the call."""
    dt = flat_boxes.dtype
    levels = port.assign_fpn_levels(flat_boxes, min_level=2,
                                    max_level=1 + len(hs))
    scale = (1.0 / torch.tensor(STRIDES, dtype=dt))[levels]
    h_l = torch.as_tensor(hs)[levels]
    w_l = torch.as_tensor(ws)[levels]
    sb = flat_boxes * scale[:, None]
    x0, y0 = sb[:, 0] - 0.5, sb[:, 1] - 0.5
    bin_w = (sb[:, 2] - sb[:, 0]) / resolution
    bin_h = (sb[:, 3] - sb[:, 1]) / resolution
    oy = torch.minimum(torch.clamp(torch.floor(y0).to(torch.int64), min=0),
                       torch.clamp(h_l - 1, min=0))
    ox = torch.minimum(torch.clamp(torch.floor(x0).to(torch.int64), min=0),
                       torch.clamp(w_l - 1, min=0))
    smp = (torch.arange(s, dtype=dt) + 0.5) / s
    offs = (torch.arange(resolution, dtype=dt)[:, None]
            + smp[None, :]).reshape(-1)
    sy_abs = y0[:, None] + offs[None, :] * bin_h[:, None]
    sx_abs = x0[:, None] + offs[None, :] * bin_w[:, None]
    hf, wf = h_l.to(dt)[:, None], w_l.to(dt)[:, None]
    valid_y = (sy_abs > -1.0) & (sy_abs < hf)
    valid_x = (sx_abs > -1.0) & (sx_abs < wf)
    sy = torch.minimum(torch.clamp(sy_abs, min=0.0), hf - 1.0) - oy.to(dt)[:, None]
    sx = torch.minimum(torch.clamp(sx_abs, min=0.0), wf - 1.0) - ox.to(dt)[:, None]
    ox_al = (ox // 8) * 8
    sx_al = sx + (ox - ox_al).to(dt)[:, None]
    ay, ax = port._fold_hats(sy, sx_al, valid_y, valid_x, resolution, s,
                             port.CPATCH)
    overflow = ((sy.amax(dim=1) > port.PATCH - 1)
                | (sx_al.amax(dim=1) > port.CPATCH - 1))
    return dict(levels=levels, oy=oy, ox_al=ox_al, sy=sy, sx_al=sx_al,
                valid_y=valid_y, valid_x=valid_x, ay=ay, ax=ax,
                overflow=overflow)


def _before_gather(flat, bases, wps, hs, ws, boxes, levels, img, resolution):
    """The exact gather ROIAlign from host constants copied at the call."""
    dt, c = boxes.dtype, flat.shape[-1]

    def per_box(values):
        return torch.as_tensor(np.asarray(values))[levels][
            :, None, None, None, None]

    scales = 1.0 / torch.tensor(STRIDES, dtype=dt)
    ys, xs = port._sample_grid(boxes, scales[levels], resolution, 2)
    h, w, hp, wp = (per_box(hs), per_box(ws), per_box(np.asarray(hs) + 48),
                    per_box(wps))
    base = per_box(bases) + (img[:, None, None, None, None] * hp) * wp
    hf, wf = h.to(dt), w.to(dt)
    valid = (ys > -1.0) & (ys < hf) & (xs > -1.0) & (xs < wf)
    y = torch.minimum(torch.clamp(ys, min=0.0), hf - 1.0)
    x = torch.minimum(torch.clamp(xs, min=0.0), wf - 1.0)
    y0, x0 = torch.floor(y).to(torch.int64), torch.floor(x).to(torch.int64)
    y1, x1 = torch.minimum(y0 + 1, h - 1), torch.minimum(x0 + 1, w - 1)
    ly, lx = (y - y0.to(dt))[..., None], (x - x0.to(dt))[..., None]

    def rows(yy, xx):
        return flat[(base + yy * wp + xx).reshape(-1)].reshape(
            *yy.shape, c).to(dt)

    out = (rows(y0, x0) * (1 - ly) * (1 - lx) + rows(y0, x1) * (1 - ly) * lx
           + rows(y1, x0) * ly * (1 - lx) + rows(y1, x1) * ly * lx)
    return torch.where(valid[..., None], out, torch.zeros(())).mean(
        dim=(3, 4))


def _before_pool(fmaps, boxes, resolution, layout):
    """The batched pooler as it was: geometry, patch kernel (plain), then
    the exact tail at its per-image budget, scattered with torch.where."""
    b, n = boxes.shape[:2]
    c = fmaps[0].shape[-1]
    hs = np.asarray([f.shape[1] for f in fmaps])
    ws = np.asarray([f.shape[2] for f in fmaps])
    flat_boxes = boxes.reshape(b * n, 4)
    img = torch.arange(b).repeat_interleave(n)
    g = _before_prep(flat_boxes, hs, ws, resolution, 2)
    row = img * torch.as_tensor(hs + 48)[g["levels"]] + g["oy"]
    if layout == "flat":
        kcat = port.flat_pool_inputs(fmaps, boxes, resolution, STRIDES).kcat
        lvl_base = np.concatenate([[0], np.cumsum((hs + 48) * b)[:-1]])
        rows = (torch.as_tensor(lvl_base)[g["levels"]] + row).to(torch.int32)
        out = kernels.roi_pool_patches_flat_reference(
            kcat, rows, g["ox_al"].to(torch.int32), g["ay"], g["ax"],
            resolution)
        wmax = kcat.shape[1]
        src, bases, wps = kcat.reshape(-1, c), lvl_base * wmax, \
            np.full(4, wmax)
    else:
        kpadded = port.level_pool_inputs(fmaps, boxes, resolution,
                                         STRIDES).kpadded
        meta = torch.stack([g["levels"], row, g["ox_al"]], 1).to(torch.int32)
        if layout == "levels":
            out = kernels.roi_pool_patches_reference(
                kpadded, meta, g["ay"], g["ax"], resolution)
        else:
            _, sec_hs, sec_ws = kernels.resident_geometry(kpadded, b, 48)
            lv = g["levels"]
            r0 = torch.minimum(g["oy"], torch.tensor(sec_hs)[lv] - 48)
            c0 = torch.minimum(g["ox_al"], torch.tensor(sec_ws)[lv] - 56)
            ay, ax = port._fold_hats(
                g["sy"] + (g["oy"] - r0).float()[:, None],
                g["sx_al"] + (g["ox_al"] - c0).float()[:, None],
                g["valid_y"], g["valid_x"], resolution, 2, port.CPATCH)
            meta = torch.stack([lv, r0, c0], 1).to(torch.int32)
            out = kernels.roi_pool_resident_reference(
                kpadded, meta, ay, ax, resolution, 48, 1, b,
                port.resident_c_split(kpadded, b))
        src = torch.cat([k.reshape(-1, c) for k in kpadded])
        sizes = np.asarray([k.shape[0] * k.shape[1] for k in kpadded])
        bases, wps = np.concatenate([[0], np.cumsum(sizes)[:-1]]), ws + 56
    m = int(np.ceil(n * (0.05 if resolution <= 8 else 0.08)))
    flag, idx = port.stable_topk(
        g["overflow"].reshape(b, n).to(torch.float32) * 2.0, m)
    sel = (torch.arange(b)[:, None] * n + idx).reshape(-1)
    take = (flag > 0).reshape(-1)
    fb = _before_gather(src, bases, wps, hs, ws, flat_boxes[sel],
                        g["levels"][sel], img[sel], resolution)
    out[sel] = torch.where(take[:, None, None, None], fb.to(out.dtype),
                           out[sel])
    sel_exact = torch.zeros(b * n, dtype=torch.bool)
    sel_exact[sel] = take
    return (out.reshape(b, n, resolution, resolution, c),
            (g["overflow"] & ~sel_exact).reshape(b, n))


# --- level tables ---------------------------------------------------------------

def test_level_table_is_copied_once_per_key(copies):
    one = port.level_table(HS, HS, STRIDES, 2, "cpu")
    assert port.level_table(list(HS), HS, STRIDES, 2, "cpu") is one
    assert port.level_table(HS, HS, list(STRIDES) + [64], 2, "cpu") is one
    assert len(copies) == 1
    other = port.level_table(HS, HS, STRIDES, 3, "cpu")
    assert other is not one and len(copies) == 2
    assert port.level_table(HS, HS, STRIDES, 3, "cpu") is other
    assert len(copies) == 2


def test_level_table_is_copied_once_from_two_threads(copies, monkeypatch):
    """Two device threads asking at once for one key: one copy, one table."""
    real = port._h2d

    def slow(make, values, **kwargs):
        time.sleep(0.05)
        return real(make, values, **kwargs)

    monkeypatch.setattr(port, "_h2d", slow)
    start = threading.Barrier(2)
    got = []

    def ask():
        start.wait()
        got.append(port.level_table(HS, HS // 2, STRIDES, 2, "cpu"))

    threads = [threading.Thread(target=ask) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(got) == 2 and got[0] is got[1]
    assert len(copies) == 1


def test_level_table_columns():
    """The table's columns, and K6's clamp bounds equal to what
    ``resident_geometry`` reads off the level buffers."""
    hs, ws = np.array([100, 50, 25, 13]), np.array([60, 30, 15, 8])
    t = port.level_table(hs, ws, STRIDES, 3, "cpu")
    assert t.packed.dtype == torch.int64 and t.packed.is_contiguous()
    assert tuple(t.packed.shape) == (4, len(kernels.TABLE_COLUMNS))
    for i, name in enumerate(kernels.TABLE_COLUMNS):
        assert torch.equal(getattr(t, name), t.packed[:, i])
    assert t.hp.tolist() == (hs + 48).tolist()
    assert t.lvl_base.tolist() == [0, 444, 738, 957]
    assert t.flat_pitch.tolist() == [116] * 4
    assert t.level_pitch.tolist() == (ws + 56).tolist()
    assert t.stride.tolist() == list(STRIDES)
    kpadded = [torch.zeros((3 * (h + 48), w + 56, 1)) for h, w in zip(hs, ws)]
    _, sec_hs, sec_ws = kernels.resident_geometry(kpadded, 3, 48)
    assert t.max_r0.tolist() == [h - 48 for h in sec_hs] == [52, 2, 0, 0]
    assert t.max_c0.tolist() == [w - 56 for w in sec_ws] == [4, 0, 0, 0]


@pytest.mark.parametrize("layout", sorted(LAYOUT_ENV))
def test_a_pooling_call_copies_nothing_after_the_first(copies, monkeypatch,
                                                      layout):
    """The level geometry stays where it was put: after the table's one
    copy, the batched pooler (box and mask pool) copies nothing from the
    host, under each layout."""
    for k, v in LAYOUT_ENV[layout].items():
        monkeypatch.setenv(k, v)
    fmaps, boxes = _fmaps(5), _boxes()
    for resolution in (7, 14):
        port.multilevel_roi_align_batched(fmaps, boxes, resolution, STRIDES)
    assert len(copies) == 1
    for resolution in (7, 14, 7):
        port.multilevel_roi_align_batched(fmaps, boxes, resolution, STRIDES)
    assert len(copies) == 1


# --- the plain versions, bit-equal to the pooler before the kernels -------------

@pytest.mark.parametrize("flat", [True, False], ids=["flat", "levels"])
@pytest.mark.parametrize("resolution", [7, 14])
def test_plain_geometry_equals_the_geometry_before(flat, resolution):
    fmaps, boxes = _fmaps(6), _boxes(seed=7)
    b, n = boxes.shape[:2]
    table = port.level_table(HS, HS, STRIDES, b, "cpu")
    g, index = port.box_geometry(boxes, table, resolution, 2, flat)
    want = _before_prep(boxes.reshape(-1, 4), HS, HS, resolution, 2)
    for name, value in want.items():
        got = getattr(g, name)
        assert got.dtype == value.dtype and torch.equal(got, value), name
    assert torch.equal(g.prio, want["overflow"].float() * 2.0)
    assert torch.equal(g.img, torch.arange(b).repeat_interleave(n))
    assert index.dtype == torch.int32 and index.is_contiguous()
    row = g.img * torch.as_tensor(HS + 48)[g.levels] + g.oy
    if flat:
        lvl_base = torch.tensor([0, 224, 384, 512])
        assert torch.equal(index[0].long(), lvl_base[g.levels] + row)
        assert torch.equal(index[1].long(), g.ox_al)
    else:
        assert torch.equal(index.long(),
                           torch.stack([g.levels, row, g.ox_al], 1))
    assert bool(g.overflow.any()) and not bool(g.overflow.all())


@pytest.mark.parametrize("layout", sorted(LAYOUT_ENV))
@pytest.mark.parametrize("resolution", [7, 14])
def test_batched_pooler_equals_the_pooler_before(monkeypatch, layout,
                                                  resolution):
    for k, v in LAYOUT_ENV[layout].items():
        monkeypatch.setenv(k, v)
    fmaps, boxes = _fmaps(8 + resolution), _boxes(seed=resolution)
    got, got_inexact = port.multilevel_roi_align_batched(
        fmaps, boxes, resolution, STRIDES)
    want, want_inexact = _before_pool(fmaps, boxes, resolution, layout)
    assert torch.equal(got, want)
    assert torch.equal(got_inexact, want_inexact)
    assert bool(got_inexact.any())      # the budget left some truncated


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "levels"])
def test_plain_exact_tail_equals_gather_and_scatter(flat):
    """The plain tail, with mixed take flags, writes what the gather and
    the ``torch.where`` scatter wrote, and leaves every other row alone."""
    resolution, b = 7, 2
    fmaps, boxes = _fmaps(9), _boxes(seed=11)
    n = boxes.shape[1]
    prep = port.flat_pool_inputs if flat else port.level_pool_inputs
    p = prep(fmaps, boxes, resolution, STRIDES)
    g = p.geom
    buffers = (p.kcat,) if flat else p.kpadded
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(np.stack([rng.permutation(n)[:6]
                                     for _ in range(b)]))
    flag = torch.from_numpy(rng.choice([0.0, 1.0, 2.0], (b, 6)).astype(
        np.float32))
    flag[0, 0], flag[1, 1] = 0.0, 2.0
    out = torch.randn(b * n, resolution, resolution, 16)
    before = out.clone()
    sel = torch.zeros(b * n, dtype=torch.bool)
    port.exact_tail(buffers, flat, g, flag, idx, out, sel, resolution, 2)

    rows = (torch.arange(b)[:, None] * n + idx).reshape(-1)
    take = (flag > 0).reshape(-1)
    c = 16
    if flat:
        wmax = p.kcat.shape[1]
        src, bases, wps = p.kcat.reshape(-1, c), p.lvl_base * wmax, \
            np.full(4, wmax)
    else:
        src = torch.cat([k.reshape(-1, c) for k in p.kpadded])
        sizes = np.asarray([k.shape[0] * k.shape[1] for k in p.kpadded])
        bases, wps = np.concatenate([[0], np.cumsum(sizes)[:-1]]), HS + 56
    fb = _before_gather(src, bases, wps, HS, HS, g.flat_boxes[rows],
                        g.levels[rows], g.img[rows], resolution)
    core = port._gather_rows_core(
        src, torch.as_tensor(bases), torch.as_tensor(wps), g.table,
        g.flat_boxes[rows], g.levels[rows], g.img[rows], resolution, 2)
    assert torch.equal(core, fb)
    want = before.clone()
    want[rows] = torch.where(take[:, None, None, None], fb, want[rows])
    assert torch.equal(out, want)
    assert torch.equal(sel, torch.zeros(b * n, dtype=torch.bool)
                       .index_put((rows,), take))
    untouched = torch.ones(b * n, dtype=torch.bool)
    untouched[rows[take]] = False
    assert torch.equal(out[untouched], before[untouched])


def test_wrappers_take_the_plain_versions_on_the_cpu(monkeypatch):
    """CPU tensors never reach a kernel library: the launchers are never
    asked for, and the counters stay where they were."""
    def no_library(*args, **kwargs):
        raise AssertionError("a kernel library was loaded for CPU tensors")

    monkeypatch.setattr(build, "load", no_library)
    counts = launch_counts()
    fmaps, boxes = _fmaps(10), _boxes(seed=12)
    out, _ = port.multilevel_roi_align_batched(fmaps, boxes, 7, STRIDES)
    assert out.shape == (2, 26, 7, 7, 16)
    assert launch_counts() == counts
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.roi_geometry(boxes.reshape(-1, 4), port.level_table(
            HS, HS, STRIDES, 2, "cpu").packed, 26, 7, 2, 48, True)


def test_k1_still_raises_for_odd_columns_on_the_cpu():
    """The card checks K1's columns without a sync (``_assert_async``); a
    tensor on the CPU still raises at the call."""
    n, r = 3, 7
    fcat = torch.zeros(100, 80, 8)
    rows = torch.zeros(n, dtype=torch.int32)
    cols = torch.tensor([0, 8, 13], dtype=torch.int32)
    ay, ax = torch.zeros(n, r, 48), torch.zeros(n, r, 56)
    with pytest.raises(ValueError, match="multiples of 8"):
        kernels.roi_pool_patches_flat(fcat, rows, cols, ay, ax, r)


def test_the_new_library_is_registered():
    assert set(kernels.PREP.entries) == {"td_roi_geometry",
                                         "td_roi_exact_tail"}
    assert kernels.PREP.sources == (build.CSRC / "roi_pool_prep.cu",)
    source = kernels.PREP.sources[0].read_text()
    for entry in kernels.PREP.entries:
        assert f"int {entry}(" in source
    # the roofline metric finds K1's, K5's and K6's kernels by these names
    for name in ("roi_pool_flat", "roi_pool_levels", "roi_pool_resident"):
        assert name not in source
    # what a warm-up builds: the pooler's libraries, and the attention's or
    # the frozen norm's for the backbone that launches it
    resnet = MaskRCNN(MaskRCNNConfig(depth=50, input_size=128))
    vit = MaskRCNN(MaskRCNNConfig(backbone="vit", input_size=128, vit_dim=64,
                                  vit_depth=1, vit_heads=1, vit_window=2,
                                  vit_global_blocks=()))
    for layout, env in LAYOUT_ENV.items():
        with pytest.MonkeyPatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            pooler = port.pooler_libraries()
            assert kernels.PREP in pooler, layout
            assert resnet.libraries() == (frozen_norm.LIBRARY,) + pooler, \
                layout
            assert vit.libraries() == (relpos_attention.LIBRARY,) + pooler
