"""Training data: tile rasters + crown annotations into fixed-shape batches.

Counterpart of ``treedetection_tpu/train/data.py`` (the reference's
``train_foundation_model.py:60-137`` tiling and 0.15 test split, and the
mask-pretraining tiler of ``pretraining_preprocessing.py:43-120``).  Tiles
are cut from the source GeoTIFF into ``.npz`` shards of static-shape arrays
(image, padded boxes, masks at input_size/4, validity) in the JAX package's
layout, so each package reads the other's shards; :class:`ShardDataset`
draws from numpy's generator in the same order, so both give the same
batches.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from treedetection_tpu_torch.config import LOGGER_NAME
from treedetection_tpu_torch.geo import Affine, GeoTiff, write_geotiff
from treedetection_tpu_torch.train.losses import MASK_DOWNSAMPLE
from treedetection_tpu_torch.vector import read_gpkg
from treedetection_tpu_torch.vector.polygon import ensure_open, polygons_bounds
from treedetection_tpu_torch.vector.rasterize import rasterize_polygon

PIXEL_MEAN_BGR = (103.53, 116.28, 123.675)
PIXEL_STD_BGR = (57.375, 57.12, 58.395)


def _crowns_in_tile(crowns: List[np.ndarray], crown_bounds: np.ndarray,
                    tile_box: Tuple[float, float, float, float]) -> List[int]:
    """Indices of the crowns whose bounds lie inside ``tile_box``."""
    minx, miny, maxx, maxy = tile_box
    hit = ((crown_bounds[:, 0] >= minx) & (crown_bounds[:, 2] <= maxx) &
           (crown_bounds[:, 1] >= miny) & (crown_bounds[:, 3] <= maxy))
    return list(np.where(hit)[0])


def make_training_tiles(image_path: str, crowns_gpkg: str,
                        tile_size_m: float = 50.0, buffer_m: float = 20.0,
                        input_size: int = 1024, max_gt: int = 64,
                        min_crowns: int = 1, store_uint8: bool = False,
                        exclude_bounds: Optional[
                            Tuple[float, float, float, float]] = None
                        ) -> Iterator[Dict[str, np.ndarray]]:
    """Yield per-tile training examples from one (raster, crowns) pair.

    Each example: image (S, S, 3), float32 BGR-normalized (caffe means,
    torchvision std) or with ``store_uint8`` raw uint8 RGB, normalized by the
    train step; boxes (max_gt, 4) in input pixels; masks (max_gt, S/4, S/4)
    float32 (uint8 0/1 with ``store_uint8``); valid (max_gt,) bool.  Tiles
    with fewer than ``min_crowns`` crowns are skipped.  ``exclude_bounds``
    (x0, y0, x1, y1) drops every tile whose buffered window meets it (a
    spatial hold-out).
    """
    src = GeoTiff(image_path)
    geoms, _, _ = read_gpkg(crowns_gpkg)
    crowns = [np.asarray(g[0][0], dtype=np.float64)
              for g in geoms if g and g[0]]
    if not crowns:
        src.close()
        return
    cb = polygons_bounds(crowns)
    bounds = src.bounds
    mask_size = input_size // MASK_DOWNSAMPLE

    for tx in np.arange(bounds[0], bounds[2], tile_size_m):
        for ty in np.arange(bounds[1], bounds[3], tile_size_m):
            tile_box = (tx - buffer_m, ty - buffer_m,
                        tx + tile_size_m + buffer_m,
                        ty + tile_size_m + buffer_m)
            if exclude_bounds is not None and not (
                    tile_box[2] <= exclude_bounds[0]
                    or tile_box[0] >= exclude_bounds[2]
                    or tile_box[3] <= exclude_bounds[1]
                    or tile_box[1] >= exclude_bounds[3]):
                continue
            idxs = _crowns_in_tile(crowns, cb, tile_box)
            if len(idxs) < min_crowns:
                continue
            arr, wt = src.read_bounds(*tile_box, fill_value=0)
            if arr.shape[0] < 4 or arr.shape[1] < 4:
                continue
            h, w = arr.shape[:2]
            img = arr[:, :, :3].astype(np.float32)
            if arr.dtype == np.uint16:
                img = img / 257.0
            sy, sx = input_size / h, input_size / w
            if store_uint8:
                img = np.clip(_resize_image(img, input_size, input_size),
                              0, 255).astype(np.uint8)
            else:
                img = (img[:, :, ::-1]
                       - np.asarray(PIXEL_MEAN_BGR, dtype=np.float32)
                       ) / np.asarray(PIXEL_STD_BGR, dtype=np.float32)
                img = _resize_image(img, input_size, input_size)

            mask_dtype = np.uint8 if store_uint8 else np.float32
            boxes = np.zeros((max_gt, 4), dtype=np.float32)
            masks = np.zeros((max_gt, mask_size, mask_size), dtype=mask_dtype)
            valid = np.zeros((max_gt,), dtype=bool)
            inv = wt.invert()
            mask_t = Affine(wt.a * w / mask_size, wt.b, wt.c,
                            wt.d, wt.e * h / mask_size, wt.f)
            if len(idxs) > max_gt:
                # crowns past the budget would become background negatives
                logging.getLogger(LOGGER_NAME).warning(
                    f"tile ({tx:.0f},{ty:.0f}): {len(idxs)} crowns exceed "
                    f"max_gt={max_gt}; {len(idxs) - max_gt} dropped (raise "
                    f"max_gt or shrink tile_size_m)")
            for k, ci in enumerate(idxs[:max_gt]):
                ring = ensure_open(crowns[ci])
                cols, rows = inv.apply(ring[:, 0], ring[:, 1])
                x0, x1 = float(np.min(cols)) * sx, float(np.max(cols)) * sx
                y0, y1 = float(np.min(rows)) * sy, float(np.max(rows)) * sy
                boxes[k] = [max(x0, 0), max(y0, 0),
                            min(x1, input_size), min(y1, input_size)]
                masks[k] = rasterize_polygon(ring, mask_t,
                                             (mask_size, mask_size))
                valid[k] = True
            yield {"image": img, "boxes": boxes, "masks": masks,
                   "valid": valid}
    src.close()


def _resize_mask_np(mask: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize of a 2-D array on the host, half-pixel centers."""
    in_h, in_w = mask.shape
    ys = (np.arange(out_h) + 0.5) * in_h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * in_w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, in_h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, in_w - 1)
    y1 = np.minimum(y0 + 1, in_h - 1)
    x1 = np.minimum(x0 + 1, in_w - 1)
    ly = np.clip(ys - y0, 0, 1)[:, None]
    lx = np.clip(xs - x0, 0, 1)[None, :]
    return (mask[np.ix_(y0, x0)] * (1 - ly) * (1 - lx)
            + mask[np.ix_(y0, x1)] * (1 - ly) * lx
            + mask[np.ix_(y1, x0)] * ly * (1 - lx)
            + mask[np.ix_(y1, x1)] * ly * lx)


def _resize_image(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Host bilinear resize of an HWC array, channel by channel."""
    return np.stack([_resize_mask_np(img[:, :, c], out_h, out_w)
                     for c in range(img.shape[2])], axis=-1)


def write_shards(examples: Iterator[Dict[str, np.ndarray]], out_dir: str,
                 shard_size: int = 64, prefix: str = "train") -> List[str]:
    """Pack examples into ``<prefix>_00000.npz``... shards of
    ``shard_size`` examples each (the last one shorter)."""
    os.makedirs(out_dir, exist_ok=True)
    shard: List[Dict[str, np.ndarray]] = []
    paths: List[str] = []

    def flush():
        if not shard:
            return
        path = os.path.join(out_dir, f"{prefix}_{len(paths):05d}.npz")
        np.savez_compressed(path, **{key: np.stack([e[key] for e in shard])
                                     for key in shard[0]})
        paths.append(path)
        shard.clear()

    for ex in examples:
        shard.append(ex)
        if len(shard) >= shard_size:
            flush()
    flush()
    return paths


def train_test_split(paths: Sequence[str], test_frac: float = 0.15,
                     n_folds: int = 1, seed: int = 0
                     ) -> List[Tuple[List[str], List[str]]]:
    """Shard-level train/test split with K folds (the reference's
    ``to_traintest_folders``: test_frac 0.15) -> [(train, test)] per fold."""
    rng = np.random.default_rng(seed)
    shuffled = list(paths)
    rng.shuffle(shuffled)
    n_test = max(1, int(round(len(shuffled) * test_frac))) if shuffled else 0
    test = shuffled[:n_test]
    train = shuffled[n_test:]
    if n_folds <= 1:
        return [(train, test)]
    folds = []
    per = max(1, len(train) // n_folds)
    for f in range(n_folds):
        val = train[f * per:(f + 1) * per]
        tr = [p for p in train if p not in val]
        folds.append((tr, val or test))
    return folds


class ShardDataset:
    """Iterate ``.npz`` shards as batches of a static size.  Each pass
    shuffles the shards and the examples within each (numpy's generator
    seeded ``seed + epoch``); a last partial batch is padded by repeating
    its examples."""

    def __init__(self, shard_paths: Sequence[str], batch_size: int,
                 shuffle: bool = True, seed: int = 0):
        self.paths = list(shard_paths)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        paths = list(self.paths)
        if self.shuffle:
            rng.shuffle(paths)
        buf: Dict[str, List[np.ndarray]] = {}
        for path in paths:
            with np.load(path) as z:
                arrays = {k: z[k] for k in z.files}
            n = len(next(iter(arrays.values())))
            order = rng.permutation(n) if self.shuffle else np.arange(n)
            for i in order:
                for k, v in arrays.items():
                    buf.setdefault(k, []).append(v[i])
                if len(next(iter(buf.values()))) == self.batch_size:
                    yield {k: np.stack(v) for k, v in buf.items()}
                    buf = {}
        if buf:
            n_orig = len(next(iter(buf.values())))
            for i in range(n_orig, self.batch_size):
                for k in buf:
                    buf[k].append(buf[k][i % n_orig])
            yield {k: np.stack(v) for k, v in buf.items()}


def prepare_pretraining_tiles(rgb_path: str, mask_path: str, out_dir: str,
                              tile_size_m: float = 250.0,
                              buffer_m: float = 200.0, test_frac: float = 0.2,
                              seed: int = 0) -> Tuple[List[str], List[str]]:
    """Mask-pretraining tiler: cut RGB + mask raster pairs into buffered
    tiles under ``out_dir/{train,test}`` (masks binarized to 0/255), each
    tile to test with probability ``test_frac`` -> (train files, test
    files)."""
    rgb = GeoTiff(rgb_path)
    msk = GeoTiff(mask_path)
    train_dir = os.path.join(out_dir, "train")
    test_dir = os.path.join(out_dir, "test")
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(test_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    bounds = rgb.bounds
    train_files, test_files = [], []
    stem = Path(rgb_path).stem
    for tx in np.arange(bounds[0], bounds[2], tile_size_m):
        for ty in np.arange(bounds[1], bounds[3], tile_size_m):
            box = (tx - buffer_m, ty - buffer_m,
                   tx + tile_size_m + buffer_m, ty + tile_size_m + buffer_m)
            img, wt = rgb.read_bounds(*box, fill_value=0)
            m, _ = msk.read_bounds(*box, fill_value=0)
            binary = (m[:, :, 0] > 0).astype(np.uint8) * 255
            dest = test_dir if rng.random() < test_frac else train_dir
            name = f"{stem}_{int(tx)}_{int(ty)}"
            img_path = os.path.join(dest, f"{name}.tif")
            rgb8 = img[:, :, :3]
            if rgb8.dtype == np.uint16:    # 16-bit: rescale, not mod 256
                rgb8 = rgb8 / 257.0
            write_geotiff(img_path, rgb8.astype(np.uint8), wt, crs=rgb.crs)
            write_geotiff(os.path.join(dest, f"{name}_mask.tif"),
                          binary, wt, crs=rgb.crs)
            (train_files if dest == train_dir else test_files).append(img_path)
    rgb.close()
    msk.close()
    return train_files, test_files
