"""K2/K3/K4 on the CPU: the port's plain versions (what the wrappers run for
CPU tensors, and what the CUDA kernel is held against on the card) against
the JAX package's Pallas kernels in interpret mode and its dense jnp
versions.  Tolerance: the masks are identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treedetection_tpu.ops.pallas import iou_kernel as jk
from treedetection_tpu_torch.ops.kernels import pairwise as pw


def _boxes(rng, n, extent=200.0):
    c = rng.uniform(0, extent, (n, 2))
    wh = rng.uniform(2, 35, (n, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], axis=1).astype(np.float32)


def _areas(rng, boxes):
    box = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return (box * rng.uniform(0.5, 1.5, len(boxes))).astype(np.float32)


def _adversarial():
    """Identical boxes, zero-area boxes, a box exactly inside another,
    polygon areas equal (rel = 0) and zero (the 1e-9 floor)."""
    boxes = np.array([
        [0, 0, 10, 10], [0, 0, 10, 10],          # identical
        [5, 5, 5, 5], [3, 3, 3, 9],              # zero area (point, segment)
        [2, 2, 6, 6],                            # exactly inside box 0
        [0, 0, 10, 9], [1, 0, 10, 10],           # ratio 0.9 / IoU 0.9 edges
        [20, 20, 30, 30], [20, 20, 30, 30],
        [100, 100, 101, 101],
    ], dtype=np.float32)
    areas = np.array([50, 50, 0, 0, 16, 90, 90, 0, 0, 1], dtype=np.float32)
    return boxes, areas


def _cases():
    rng = np.random.default_rng(7)
    out = {}
    for name, n, rows in (("square_200", 200, None), ("n_not_128", 131, None),
                          ("n_1", 1, None), ("rows_block", 300, (64, 141)),
                          ("rows_ragged", 257, (250, 257))):
        b = _boxes(rng, n, extent=12.0 * np.sqrt(n))
        out[name] = (b, _areas(rng, b), rows)
    zb = _boxes(rng, 40)
    zb[::5, 2] = zb[::5, 0]                      # zero-width boxes
    out["zero_area"] = (zb, _areas(rng, zb), None)
    ab, aa = _adversarial()
    out["adversarial"] = (ab, aa, None)
    out["adversarial_rows"] = (ab, aa, (2, 7))
    return out


CASES = _cases()


def _rows(arr, rows):
    return None if rows is None else arr[rows[0]:rows[1]]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("thr", [0.5, 0.9, 1.0])
def test_iou_mask_matches_jax(case, thr):
    b, _, rows = CASES[case]
    r = _rows(b, rows)
    ours = pw.pairwise_iou_mask(
        torch.from_numpy(b), thr,
        rows=None if r is None else torch.from_numpy(r)).numpy()
    jr = None if r is None else jnp.asarray(r)
    pallas = np.asarray(jk.pairwise_iou_mask(jnp.asarray(b), thr, rows=jr,
                                             force_interpret=True))
    dense = np.asarray(jk.pairwise_iou_mask(jnp.asarray(b), thr, rows=jr))
    assert ours.dtype == np.uint8 and ours.shape == pallas.shape
    np.testing.assert_array_equal(ours, pallas)
    np.testing.assert_array_equal(ours, dense)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("thr", [0.9, 1.0])
def test_containment_mask_matches_jax(case, thr):
    b, _, rows = CASES[case]
    r = _rows(b, rows)
    ours = pw.pairwise_containment_mask(
        torch.from_numpy(b), thr,
        rows=None if r is None else torch.from_numpy(r)).numpy()
    jr = None if r is None else jnp.asarray(r)
    pallas = np.asarray(jk.pairwise_containment_mask(
        jnp.asarray(b), thr, rows=jr, force_interpret=True))
    dense = np.asarray(jk.pairwise_containment_mask(jnp.asarray(b), thr,
                                                    rows=jr))
    np.testing.assert_array_equal(ours, pallas)
    np.testing.assert_array_equal(ours, dense)
    if rows is None:
        assert not ours.diagonal().any()      # the square case's rule


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("thr", [(0.5, 0.3), (0.9, 1e-6)])
def test_dedupe_mask_matches_jax(case, thr):
    b, a, rows = CASES[case]
    r, ra = _rows(b, rows), _rows(a, rows)
    kw = {} if r is None else {"rows": torch.from_numpy(r),
                               "row_areas": torch.from_numpy(ra)}
    ours = pw.pairwise_dedupe_mask(torch.from_numpy(b), torch.from_numpy(a),
                                   thr[0], thr[1], **kw).numpy()
    jkw = {} if r is None else {"rows": jnp.asarray(r),
                                "row_areas": jnp.asarray(ra)}
    pallas = np.asarray(jk.pairwise_dedupe_mask(
        jnp.asarray(b), jnp.asarray(a), thr[0], thr[1],
        force_interpret=True, **jkw))
    dense = np.asarray(jk.pairwise_dedupe_mask(
        jnp.asarray(b), jnp.asarray(a), thr[0], thr[1], **jkw))
    np.testing.assert_array_equal(ours, pallas)
    np.testing.assert_array_equal(ours, dense)


def test_adversarial_entries_by_hand():
    """The entries the adversarial rows are there for."""
    b, a = _adversarial()
    tb, ta = torch.from_numpy(b), torch.from_numpy(a)
    iou = pw.pairwise_iou_mask(tb, 0.5).numpy()
    assert iou[0, 1] == 1 and iou[0, 0] == 1          # identical boxes
    assert not iou[2].any() and not iou[:, 3].any()   # zero area: union rule
    cont = pw.pairwise_containment_mask(tb, 1.0).numpy()
    assert cont[0, 4] == 1 and cont[4, 0] == 0        # ratio exactly 1.0
    assert cont[0, 1] == 1 and cont[0, 0] == 0        # diagonal cleared
    assert not cont[:, 2].any()                       # area(b_j) == 0 -> 0
    cont9 = pw.pairwise_containment_mask(tb, 0.9).numpy()
    assert cont9[0, 4] == 1 and cont9[6, 0] == 1      # 0.9 >= 0.9 in float32
    ded = pw.pairwise_dedupe_mask(tb, ta, 0.5, 0.3).numpy()
    assert ded[0, 1] == 1                             # areas equal: rel = 0
    assert ded[7, 8] == 1                             # areas 0: the floor
    assert ded[0, 5] == 0                             # IoU 0.9 but rel 0.44


def test_empty_inputs_return_empty_masks():
    e4 = torch.zeros((0, 4))
    b = torch.from_numpy(_boxes(np.random.default_rng(0), 5))
    assert pw.pairwise_iou_mask(e4, 0.5).shape == (0, 0)
    assert pw.pairwise_iou_mask(b, 0.5, rows=e4).shape == (0, 5)
    assert pw.pairwise_containment_mask(e4, 0.9, rows=b).shape == (5, 0)
    assert pw.pairwise_dedupe_mask(e4, torch.zeros(0), 0.5).shape == (0, 0)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "areas"])
def test_wrappers_reject_bad_inputs(bad):
    b = torch.from_numpy(_boxes(np.random.default_rng(0), 6))
    a = torch.ones(6)
    with pytest.raises((TypeError, ValueError)):
        if bad == "dtype":
            pw.pairwise_iou_mask(b.double(), 0.5)
        elif bad == "shape":
            pw.pairwise_containment_mask(b[:, :3].contiguous(), 0.9)
        elif bad == "contiguous":
            pw.pairwise_iou_mask(b, 0.5, rows=torch.zeros(6, 8)[:, ::2])
        else:
            pw.pairwise_dedupe_mask(b, a[:5], 0.5)


# --- the bit-packed relation and its pairs (K2, K3 on the crown filter's path)

def _huge_coordinates():
    """Crown boxes with a few boxes reaching past 2^126 in magnitude (finite):
    the CUDA kernel takes its whole formula for these, so the plain version
    must hold such rows too."""
    rng = np.random.default_rng(11)
    b = _boxes(rng, 60, extent=80.0)
    b[::13, 0] = -3e38
    b[::13, 2] = 3e38
    b[5, 1], b[5, 3] = -1e38, 2e38
    return b, _areas(rng, np.clip(b, -1e3, 1e3)), None


BITS_CASES = dict(CASES, huge_coordinates=_huge_coordinates())
BITS_THRESHOLDS = {"containment": [(0.9, 0.0), (1.0, 0.0), (0.0, 0.0)],
                   "dedupe": [(0.5, 0.3), (0.9, 1e-6), (-0.1, 0.3)]}
BITS_PARAMS = [(mode, thr) for mode, thrs in BITS_THRESHOLDS.items()
               for thr in thrs]


def _jax_masks(case, mode, thr):
    """The JAX package's mask of one case, from Pallas in interpret mode and
    from its dense jnp version."""
    b, a, rows = BITS_CASES[case]
    r, ra = _rows(b, rows), _rows(a, rows)
    out = []
    for interpret in (True, False):
        if mode == "containment":
            m = jk.pairwise_containment_mask(
                jnp.asarray(b), thr[0],
                rows=None if r is None else jnp.asarray(r),
                force_interpret=interpret)
        else:
            kw = {} if r is None else {"rows": jnp.asarray(r),
                                       "row_areas": jnp.asarray(ra)}
            m = jk.pairwise_dedupe_mask(jnp.asarray(b), jnp.asarray(a),
                                        thr[0], thr[1],
                                        force_interpret=interpret, **kw)
        out.append(np.asarray(m))
    return out


def _bits(case, mode, thr):
    b, a, rows = BITS_CASES[case]
    r, ra = _rows(b, rows), _rows(a, rows)
    if mode == "containment":
        return pw.pairwise_containment_bits(
            torch.from_numpy(b), thr[0],
            rows=None if r is None else torch.from_numpy(r))
    kw = {} if r is None else {"rows": torch.from_numpy(r),
                               "row_areas": torch.from_numpy(ra)}
    return pw.pairwise_dedupe_bits(torch.from_numpy(b), torch.from_numpy(a),
                                   thr[0], thr[1], **kw)


@pytest.mark.parametrize("case", sorted(BITS_CASES))
@pytest.mark.parametrize("mode,thr", BITS_PARAMS)
def test_bits_equal_packbits_of_jax_mask(case, mode, thr):
    """The bit-packed wrappers' plain version equals np.packbits of the JAX
    mask (Pallas in interpret mode and the dense version), thresholds <= 0
    included (every non-meeting pair is then a hit).  Exact."""
    ours = _bits(case, mode, thr).numpy()
    for jax_mask in _jax_masks(case, mode, thr):
        assert ours.dtype == np.uint8
        np.testing.assert_array_equal(ours, np.packbits(jax_mask, axis=1))


@pytest.mark.parametrize("case", sorted(BITS_CASES))
@pytest.mark.parametrize("mode,thr", BITS_PARAMS)
def test_relation_pairs_equal_nonzero_of_jax_mask(case, mode, thr):
    """relation_pairs' plain version equals np.nonzero of the JAX mask with
    the row offset added and the diagonal dropped, as whole arrays in
    np.nonzero's order (what the crown filter's device branch does with each
    row block)."""
    b, _, rows = BITS_CASES[case]
    s = 0 if rows is None else rows[0]
    pallas, _ = _jax_masks(case, mode, thr)
    ii, jj = np.nonzero(pallas)
    ii = ii + s
    keep = ii != jj
    got = pw.relation_pairs(_bits(case, mode, thr), len(b), row_offset=s,
                            drop_diagonal=True).numpy()
    assert got.dtype == np.int32 and got.shape == (2, int(keep.sum()))
    np.testing.assert_array_equal(got[0], ii[keep])
    np.testing.assert_array_equal(got[1], jj[keep])


@pytest.mark.parametrize("n", [1, 7, 8, 31, 33, 100, 257])
@pytest.mark.parametrize("fill", ["random", "empty", "all_ones"])
def test_relation_pairs_plain_version(n, fill):
    """N % 8 != 0 and N % 32 != 0, an empty and an all-ones relation:
    relation_pairs equals np.nonzero, with and without the diagonal, at a
    row offset that puts the diagonal inside and outside the block."""
    rng = np.random.default_rng(n)
    r = 9
    m = {"random": (rng.random((r, n)) < 0.3).astype(np.uint8),
         "empty": np.zeros((r, n), np.uint8),
         "all_ones": np.ones((r, n), np.uint8)}[fill]
    bits = torch.from_numpy(np.packbits(m, axis=1))
    for offset in (0, 5, 1000):
        for drop in (True, False):
            ii, jj = np.nonzero(m)
            ii = ii + offset
            if drop:
                ii, jj = ii[ii != jj], jj[ii != jj]
            got = pw.relation_pairs(bits, n, row_offset=offset,
                                    drop_diagonal=drop).numpy()
            np.testing.assert_array_equal(got, np.stack([ii, jj]))


def test_pack_bits_rows_and_empty_bits():
    """pack_bits_rows is np.packbits; empty blocks give empty outputs."""
    m = (np.random.default_rng(3).random((6, 45)) < 0.5).astype(np.uint8)
    np.testing.assert_array_equal(
        pw.pack_bits_rows(torch.from_numpy(m)).numpy(), np.packbits(m, axis=1))
    e4 = torch.zeros((0, 4))
    b = torch.from_numpy(_boxes(np.random.default_rng(0), 5))
    assert pw.pairwise_containment_bits(b, 0.9, rows=e4).shape == (0, 1)
    assert pw.pairwise_containment_bits(e4, 0.9, rows=b).shape == (5, 0)
    assert pw.pairwise_dedupe_bits(e4, torch.zeros(0), 0.5).shape == (0, 0)
    assert pw.relation_pairs(torch.zeros((0, 1), dtype=torch.uint8),
                             5).shape == (2, 0)
    with pytest.raises(ValueError):
        pw.relation_pairs(torch.zeros((3, 2), dtype=torch.uint8), 5)
    with pytest.raises(TypeError):
        pw.relation_pairs(torch.zeros((3, 1), dtype=torch.int32), 5)


@pytest.mark.parametrize("n", [1, 31, 33, 100, 4099])
def test_word_readable_rule_of_the_compaction_kernels(n):
    """The rule the card's relation_pairs holds a block to: a view of a block
    at the kernel's pitch (what the bit-packed wrappers return) is read in
    place; a tight (R, ceil(N/8)) copy passes only when ceil(N/8) is a
    multiple of 4, and is otherwise refused rather than copied."""
    nbytes = (n + 7) // 8
    pitched = torch.zeros((5, pw._bits_pitch(n)), dtype=torch.uint8)
    pw._check_word_readable(pitched[:, :nbytes], n)
    pw._check_word_readable(pitched[2:, :nbytes], n)
    tight = torch.zeros((5, nbytes), dtype=torch.uint8)
    if nbytes % 4 == 0:
        pw._check_word_readable(tight, n)
    else:
        with pytest.raises(ValueError, match="4-byte words"):
            pw._check_word_readable(tight, n)
    # a row that starts off a 4-byte boundary
    with pytest.raises(ValueError, match="4-byte words"):
        pw._check_word_readable(pitched.reshape(-1)[1:1 + 4 * 16 * (
            pw._bits_pitch(n) // 16)].reshape(4, -1)[:, :nbytes], n)
