"""The port's training data pipeline and training loop against the JAX
package's (``treedetection_tpu/train/data.py``, ``train.train_model``) on
the CPU: the same arrays (exactly) from the same rasters and crowns, shards
that either package writes read by the other in the same batch order, the
same splits, the same pretraining tiles; and ``train_model`` on tiny shards
with validation giving JAX's history lengths, improvements and early-stop
step.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest

from test_torch_train_losses import torch_threads  # noqa: F401 (a fixture)
from test_train import TINY
from treedetection_tpu.geo import Affine as JaxAffine
from treedetection_tpu.geo import GeoTiff as JaxGeoTiff
from treedetection_tpu.geo import write_geotiff as jax_write_geotiff
from treedetection_tpu.train import data as jd
from treedetection_tpu.train import train as jt
from treedetection_tpu.vector import write_gpkg as jax_write_gpkg

from treedetection_tpu_torch.geo import GeoTiff
from treedetection_tpu_torch.models.convert import from_flax_params
from treedetection_tpu_torch.train import data as td
from treedetection_tpu_torch.train import train as tt


def _square(x0, y0, s):
    return np.array([[x0, y0], [x0 + s, y0], [x0 + s, y0 + s],
                     [x0, y0 + s]], float)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 100 m x 100 m RGBI raster at 0.5 m (uint8 and uint16) with 40
    square crowns, 6 of them packed into one corner."""
    d = tmp_path_factory.mktemp("scene")
    rng = np.random.default_rng(0)
    t = JaxAffine.from_origin(0.0, 100.0, 0.5, 0.5)
    img = rng.integers(0, 255, (200, 200, 4), dtype=np.uint8)
    tif8, tif16 = str(d / "img.tif"), str(d / "img16.tif")
    jax_write_geotiff(tif8, img, t, crs=25832)
    jax_write_geotiff(tif16, img.astype(np.uint16) * 257 + 3, t, crs=25832)
    crowns = [_square(*rng.uniform(2, 88, 2), rng.uniform(2, 10))
              for _ in range(34)]
    crowns += [_square(3 + 2.5 * i, 3, 2) for i in range(6)]
    gpkg = str(d / "crowns.gpkg")
    jax_write_gpkg(gpkg, crowns, [{"Confidence_score": 1.0}] * len(crowns))
    return d, tif8, tif16, gpkg


def _same_examples(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("kw", [
    {},
    {"store_uint8": True},
    {"max_gt": 3, "min_crowns": 2},
    {"exclude_bounds": (70.0, 0.0, 100.0, 40.0), "store_uint8": True},
    {"tile_size_m": 40.0, "buffer_m": 5.0, "input_size": 96}],
    ids=["float", "uint8", "max_gt", "exclude", "other_tiles"])
def test_training_tiles_equal_jax(scene, kw):
    _, tif8, tif16, gpkg = scene
    args = dict(tile_size_m=50, buffer_m=10, input_size=128, max_gt=8)
    args.update(kw)
    for tif in (tif8, tif16):
        _same_examples(list(td.make_training_tiles(tif, gpkg, **args)),
                       list(jd.make_training_tiles(tif, gpkg, **args)))


@pytest.fixture(scope="module")
def examples(scene):
    _, tif8, _, gpkg = scene
    return list(jd.make_training_tiles(tif8, gpkg, tile_size_m=30,
                                       buffer_m=5, input_size=64, max_gt=6,
                                       store_uint8=True))


def _batches(ds, epochs=2):
    return [b for _ in range(epochs) for b in ds]


@pytest.mark.parametrize("shuffle,batch_size,seed",
                         [(True, 3, 0), (True, 4, 7), (False, 3, 0)])
def test_shards_cross_between_packages(examples, tmp_path, shuffle,
                                       batch_size, seed):
    """JAX's shards through the port's ShardDataset and the port's shards
    through JAX's: the same batches in the same order over two epochs,
    last partial batches padded alike."""
    assert len(examples) % batch_size       # a partial batch is padded
    jpaths = jd.write_shards(iter(examples), str(tmp_path / "j"),
                             shard_size=4)
    tpaths = td.write_shards(iter(examples), str(tmp_path / "t"),
                             shard_size=4)
    assert [os.path.basename(p) for p in jpaths] == \
        [os.path.basename(p) for p in tpaths]
    ref = _batches(jd.ShardDataset(jpaths, batch_size, shuffle, seed))
    _same_examples(_batches(td.ShardDataset(jpaths, batch_size, shuffle,
                                            seed)), ref)
    _same_examples(_batches(jd.ShardDataset(tpaths, batch_size, shuffle,
                                            seed)), ref)


@pytest.mark.parametrize("n,frac,folds,seed", [
    (20, 0.15, 1, 0), (7, 0.5, 3, 4), (1, 0.15, 1, 0), (0, 0.15, 1, 0),
    (12, 0.2, 4, 9)])
def test_train_test_split_matches_jax(n, frac, folds, seed):
    paths = [f"shard_{i:05d}.npz" for i in range(n)]
    assert td.train_test_split(paths, frac, folds, seed) == \
        jd.train_test_split(paths, frac, folds, seed)


def test_prepare_pretraining_tiles_match_jax(scene, tmp_path):
    d, tif8, tif16, _ = scene
    mask = np.zeros((200, 200, 1), dtype=np.uint8)
    mask[50:120, 30:90] = 7
    mpath = str(d / "mask.tif")
    jax_write_geotiff(mpath, mask, JaxAffine.from_origin(0.0, 100.0, 0.5, 0.5),
                      crs=25832)
    for tif in (tif8, tif16):
        kw = dict(tile_size_m=40.0, buffer_m=10.0, test_frac=0.4, seed=2)
        ours = td.prepare_pretraining_tiles(tif, mpath, str(tmp_path / "t"),
                                            **kw)
        ref = jd.prepare_pretraining_tiles(tif, mpath, str(tmp_path / "j"),
                                           **kw)
        strip = [[os.path.relpath(p, tmp_path / "t") for p in ours[i]]
                 for i in range(2)]
        assert strip == [[os.path.relpath(p, tmp_path / "j") for p in ref[i]]
                         for i in range(2)]
        assert ref[0] and ref[1]
        for ours_p, ref_p in zip(ours[0] + ours[1], ref[0] + ref[1]):
            for suffix in ("", "_mask"):
                a = GeoTiff(ours_p.replace(".tif", f"{suffix}.tif"))
                b = JaxGeoTiff(ref_p.replace(".tif", f"{suffix}.tif"))
                np.testing.assert_array_equal(a.read(), b.read())
                assert a.transform == b.transform and a.crs == b.crs


def test_train_model_history_matches_jax(examples, tmp_path):
    """Both loops on the same shards, init and config, with validation
    every step and patience 1 at a learning rate that overshoots: the same
    number of steps and evaluations, and the early stop at the same step."""
    from treedetection_tpu.models.mask_rcnn import create_model
    paths = jd.write_shards(iter(examples), str(tmp_path / "s"), shard_size=4)
    (train, val), = jd.train_test_split(paths, 0.3)
    cfg = dataclasses.replace(TINY, input_size=64)
    _, params = create_model(cfg)
    kw = dict(max_iter=8, eval_period=1, patience=1, base_lr=2.0,
              warmup_iters=1, ims_per_batch=2, max_eval_batches=2,
              backbone_freeze=0)
    _, ref = jt.train_model(jd.ShardDataset(train, 2),
                            jd.ShardDataset(val, 2, shuffle=False),
                            model_cfg=cfg, train_cfg=jt.TrainConfig(**kw),
                            init_params=params)
    from test_torch_train_losses import port_cfg
    _, got = tt.train_model(td.ShardDataset(train, 2),
                            td.ShardDataset(val, 2, shuffle=False),
                            model_cfg=port_cfg(input_size=64),
                            train_cfg=tt.TrainConfig(**kw),
                            init_params=from_flax_params(
                                jax.device_get(params)),
                            device="cpu")
    assert len(got["total_loss"]) == len(ref["total_loss"])
    assert len(got["val_loss"]) == len(ref["val_loss"])
    assert len(ref["total_loss"]) < kw["max_iter"], "no early stop"

    def improved(vals):
        return [v < min(vals[:i], default=np.inf) for i, v in enumerate(vals)]
    assert improved(got["val_loss"]) == improved(ref["val_loss"])
    assert len(got["step_s"]) == len(got["total_loss"])
