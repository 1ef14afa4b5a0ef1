"""The port's fold-and-save against the JAX package's
(``treedetection_tpu/models/convert.py``: ``fold_batch_stats``,
``save_checkpoint_npz``, ``load_checkpoint``) on the CPU.

- ``to_flax_params`` gives JAX's variables leaf for leaf (keys, shapes,
  values) in both norm modes, and ``from_flax_params`` undoes it exactly;
- ``fold_batch_stats`` and ``save_checkpoint_npz`` write JAX's keys and
  arrays, each leaf in the same dtype (the fp16 flush and overflow guard
  included), bit for bit;
- a checkpoint that the port writes after one batch-norm step, folded,
  loads in JAX's ``load_checkpoint``, and JAX's float32 forward on it
  (Pallas pooler in interpret mode) keeps the port's detections: the same
  kept set, boxes within 1e-2 px, scores within 1e-4.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_losses import (  # noqa: F401 (a fixture)
    KEYS, port_cfg, port_model, torch_threads)
from test_train import TINY, make_batch
from treedetection_tpu.models import convert as jc
from treedetection_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from treedetection_tpu.models.mask_rcnn import create_model as jax_create_model

from treedetection_tpu_torch.models import convert as tc
from treedetection_tpu_torch.models.mask_rcnn import MaskRCNN
from treedetection_tpu_torch.train import train as tt


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


@pytest.fixture(scope="module")
def jax_variables():
    return {norm: jax.device_get(jax_create_model(
        dataclasses.replace(TINY, norm=norm))[1])
        for norm in ("frozen", "batch")}


@pytest.mark.parametrize("norm", ["frozen", "batch"])
def test_to_flax_params_inverts_from_flax_params(jax_variables, norm):
    ref = jax_variables[norm]
    sd = tc.from_flax_params(ref)
    got = tc.to_flax_params(sd)
    a, b = _flat(got), _flat(ref)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == np.shape(b[k]) and a[k].dtype == np.float32, k
        np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)
    back = tc.from_flax_params(got)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def _stats_tree(variables, seed):
    """Batch statistics with a spread of magnitudes, tiny ones included,
    so that the fold gives scales the fp16 guard must keep at fp32."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (rng.uniform(0.5, 2.0, np.shape(a)) * 10.0 ** rng.integers(
            -9, 3, np.shape(a))).astype(np.float32), variables["batch_stats"])


def test_fold_and_npz_match_jax(jax_variables, tmp_path):
    variables = dict(jax_variables["batch"])
    variables["batch_stats"] = _stats_tree(variables, 1)
    # a large kernel with a few tiny values (flushed in fp16, warned), one
    # with many (kept at fp32), and one that overflows fp16
    p = variables["params"]
    fc2 = np.array(p["box_head"]["fc2"]["kernel"])
    fc2.flat[:5] = 1e-9
    pred = np.array(p["box_head"]["bbox_pred"]["kernel"])
    pred.flat[:600] = 1e-9
    cls = np.array(p["box_head"]["cls_score"]["kernel"])
    cls.flat[0] = 1e6
    variables["params"] = {**p, "box_head": {
        **p["box_head"], "fc2": {**p["box_head"]["fc2"], "kernel": fc2},
        "bbox_pred": {**p["box_head"]["bbox_pred"], "kernel": pred},
        "cls_score": {**p["box_head"]["cls_score"], "kernel": cls}}}
    ref_fold = jc.fold_batch_stats(variables)
    got_fold = tc.fold_batch_stats(variables)
    a, b = _flat(got_fold), _flat(ref_fold)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)
    jc.save_checkpoint_npz(str(tmp_path / "j.npz"), ref_fold)
    tc.save_checkpoint_npz(str(tmp_path / "t.npz"), got_fold)
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "t.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        dtypes = {k: zj[k].dtype for k in zj.files}
        for k in zj.files:
            assert zt[k].dtype == zj[k].dtype, k
            np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    assert {str(d) for d in dtypes.values()} == {"float16", "float32"}
    for k in ("params/box_head/bbox_pred/kernel",
              "params/box_head/cls_score/kernel"):
        assert dtypes[k] == np.float32, k
    assert dtypes["params/box_head/fc2/kernel"] == np.float16
    # an unfolded frozen tree passes through the fold unchanged
    plain = jax_variables["frozen"]
    assert all(np.array_equal(x, np.asarray(y)) for x, y in zip(
        _flat(tc.fold_batch_stats(plain)).values(), _flat(plain).values()))


def test_port_checkpoint_serves_in_jax(jax_variables, tmp_path, monkeypatch):
    """One batch-norm train step in the port, folded and saved as fp16
    npz; JAX's ``load_checkpoint`` and the port's read it; both forwards on
    the same images keep the same detections."""
    import treedetection_tpu.models.mask_rcnn as jmr
    from treedetection_tpu.ops.roi_align import (
        multilevel_roi_align_batched as jax_pool)
    model = port_model(jax_variables["batch"], norm="batch")
    step = tt.make_train_step(model, tt.make_optimizer(
        tt.TrainConfig.from_preset("scratch", backbone_freeze=0), model))
    batch = make_batch()
    step({k: torch.from_numpy(batch[k]) for k in KEYS})
    path = str(tmp_path / "trained.npz")
    tc.save_checkpoint_npz(path, tc.fold_batch_stats(
        tc.to_flax_params(model.state_dict())))

    jparams = jc.load_checkpoint(path, depth=50)
    serve_cfg = dataclasses.replace(TINY, score_threshold=0.05)
    port = MaskRCNN(port_cfg(score_threshold=0.05)).eval()
    port.load_state_dict(tc.load_checkpoint(path, depth=50), strict=True)
    monkeypatch.setattr(jmr, "multilevel_roi_align_batched", functools.partial(
        jax_pool, pallas=True, force_interpret=True))
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 128, 128, 3)).astype(np.float32)
    want = jax.jit(lambda p, im: JaxMaskRCNN(serve_cfg).apply(p, im))(
        jparams, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    valid = np.asarray(want.valid)
    assert valid.sum() > 0, "no detections: the comparison is vacuous"
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_allclose(got.boxes.numpy()[valid],
                               np.asarray(want.boxes)[valid], rtol=0,
                               atol=1e-2)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-4)
