"""Stage orchestration — the public pipeline API.

Mirrors the reference's user-facing surface exactly (reference
``detection.py:23,134,256,342,375``): ``process_files`` runs
preprocess -> predict -> postprocess -> cleanup with per-stage wall-clock
timing, each stage re-runnable independently and resumable via the
``recoveries`` manifests.  Inter-stage coupling is via the filesystem with
the reference's file naming, so partial runs interoperate.

Layout under ``output_directory``:
``predictions/<image_stem>/Prediction_<tile_id>.json`` (per-tile),
``predictions/<stem>.gpkg`` (stitched), ``processed_<stem>.gpkg`` (filtered),
and the final copies at the output root (reference ``detection.py:46-59``).

Ported: one combined model, or two-model routing (``urban_model`` +
``forrest_model`` + ``forrest_outline``: an urban pass that skips forest-only
tiles, a forest pass that skips urban-only tiles, fused by the outline), on
one or several devices (``parallel.make_mesh``) of one or several hosts.

Multi-host: every host runs ``process_files`` on shared storage, under
torchrun (``torch.distributed`` over gloo, initialised by
``parallel.ensure_distributed``) or with ``TREEDETECTION_NUM_HOSTS`` /
``TREEDETECTION_HOST_ID``.  Seams are planned over the full image list; each
host tiles its slice (``parallel.partition_files``) plus the strips whose
primary raster it owns, predicts its slice, and postprocesses the stitched
layers of its slice (host 0 also the layers no host's image names), with
barriers between the stages and the totals all-gathered at the end.  Left
out by decision: the compile warm-up thread and the device gate of the JAX
package (CUDA streams order the work of the predict thread and of the
postprocess worker).
"""

from __future__ import annotations

import glob
import os
import re
import shutil
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from treedetection_tpu_torch.config import Config
from treedetection_tpu_torch import recoveries
from treedetection_tpu_torch.merging import merge_and_crop_images
from treedetection_tpu_torch.parallel.mesh import (
    current_host_id, current_num_hosts, ensure_distributed, partition_files,
    process_count)
from treedetection_tpu_torch.preprocessing import tile_data, load_tile_metadata
from treedetection_tpu_torch.stitching import process_and_stitch_predictions


# Wall-clock seconds of the stages of the most recent process_files call.
LAST_STAGE_SECONDS: Dict[str, float] = {}
# Seconds each barrier of the most recent multi-process process_files call
# waited for the other hosts (inside the stage seconds above).
LAST_BARRIER_SECONDS: Dict[str, float] = {}
# [files, crowns] of each host, all-gathered at the end of the most recent
# multi-process process_files call.
LAST_MULTIHOST_TOTALS: List[List[int]] = []


def _predictions_dir(config: Dict[str, Any]) -> str:
    return os.path.join(config["output_directory"], "predictions")


def _list_images(config: Dict[str, Any],
                 partition: bool = True) -> Tuple[List[str], List[str]]:
    """Glob + continue-filter + merged-strip inclusion for both directories
    (reference ``detection.py:277-285``).

    On a multi-host run each process sees only its deterministic slice of
    the image list (``parallel.partition_files``); height rasters are NOT
    partitioned because any image may need any height twin.  Pass
    ``partition=False`` for the FULL list (wherever planning must see every
    raster, e.g. the cross-host seam-neighbor search)."""
    images = sorted(glob.glob(os.path.join(config["image_directory"], "*.tif")))
    heights = sorted(glob.glob(os.path.join(config["height_data_path"], "*.tif")))
    merged = config.get("merged_path", "merged")
    images += sorted(glob.glob(os.path.join(
        config["image_directory"], merged, "*.tif")))
    heights += sorted(glob.glob(os.path.join(
        config["height_data_path"], merged, "*.tif")))
    skip = set(recoveries.load_continue_file(config.get("continue")))
    images = [p for p in images if os.path.basename(p) not in skip
              and p not in skip]
    if partition and current_num_hosts() > 1:
        images = partition_files(images)
    return images, heights


def match_image_heights(config: Dict[str, Any], images: List[str],
                        heights: List[str]) -> Dict[str, Optional[str]]:
    """Pair images with height rasters by concatenated regex groups
    (reference ``detection.py:288-311``)."""
    logger = config.get("logger")
    img_rx = [config.get("image_regex", r"(\d+)\.tif")]
    h_rx = [config.get("height_data_regex", r"(\d+)\.tif")]
    if config.get("image_merged_regex"):
        img_rx.append(config["image_merged_regex"])
    if config.get("height_data_merged_regex"):
        h_rx.append(config["height_data_merged_regex"])

    def index(paths, rxs):
        out = {}
        for p in paths:
            for rx in rxs:
                m = re.match(rx, os.path.basename(p))
                if m:
                    out["".join(m.groups())] = p
                    break
        return out

    h_index = index(heights, h_rx)
    pairs: Dict[str, Optional[str]] = {}
    for p in images:
        key = None
        for rx in img_rx:
            m = re.match(rx, os.path.basename(p))
            if m:
                key = "".join(m.groups())
                break
        if key is None:
            continue
        h = h_index.get(key)
        if h is None and logger:
            logger.warning(f"No height data matched for {os.path.basename(p)}")
        pairs[p] = h
    return pairs


# --- stage 1 ----------------------------------------------------------------

def preprocess_files(config: Dict[str, Any]) -> List[str]:
    """Overlap merging + tiling (reference ``detection.py:256-339``).

    Multi-host: seam-neighbor planning runs over the FULL image list (a
    per-host slice would drop every cross-host seam).  Each host then
    generates only the strips whose primary (left/top) raster falls in its
    slice, and tiles its slice plus its own strips.  Any host can read any
    raster from shared storage; each strip is written by exactly one host."""
    Config()._load_into_config(config)
    logger = config.get("logger")
    images_full, heights_full = _list_images(config, partition=False)
    # only base (non-merged) files participate in neighbor merging
    merged_dir = config.get("merged_path", "merged")
    base_images = [p for p in images_full if merged_dir not in Path(p).parts]
    base_heights = [p for p in heights_full if merged_dir not in Path(p).parts]
    if current_num_hosts() > 1:
        my_images = partition_files(base_images)
        my_heights = partition_files(base_heights)
    else:
        my_images, my_heights = list(base_images), list(base_heights)
    heights = list(base_heights)
    if config.get("use_overlap", True):
        images = list(base_images)
        merge_and_crop_images(config, images, heights,
                              owned_images=set(my_images),
                              owned_heights=set(my_heights))
        # tile this host's base slice + the strips it created or owns
        base_set = set(base_images)
        my_images += [p for p in images if p not in base_set]
    pairs = match_image_heights(config, my_images, heights)
    forest_outline = config.get("forrest_outline")
    tile_files = tile_data(config, list(pairs.keys()), forest_outline)
    if logger:
        logger.info(f"Tiled {len(tile_files)} images")
    return tile_files


# --- stage 2 ----------------------------------------------------------------

def predict_on_model(config: Dict[str, Any], model_path: str,
                     images: List[str], exclude_flag: Optional[str],
                     pred_root: str,
                     on_image_done=None) -> List[str]:
    """Run one model over all images with prediction recovery (reference
    ``detection.py:62-131``).

    ``on_image_done(img)`` fires after each image's predictions are on disk
    (including recovered images) — the hook the overlapped predict/
    postprocess pipeline uses to start file N's downstream work while file
    N+1 predicts.  The callback must be cheap (it runs on the predict
    thread); heavy work belongs on the callee's own executor."""
    logger = config.get("logger")
    os.makedirs(pred_root, exist_ok=True)
    tiles_dir = config["tiles_path"]
    tile_meta = {}
    for img in images:
        meta_path = os.path.join(tiles_dir, f"{Path(img).stem}.json")
        if os.path.exists(meta_path):
            tile_meta[img] = load_tile_metadata(meta_path)
    done = set(recoveries.load_prediction_recovery_data(
        pred_root, model_path, tile_meta, exclude_flag))
    predictor = None
    completed = list(done)
    processed = []
    for i, img in enumerate(images):
        if img not in tile_meta:
            if logger:
                logger.warning(f"No tile metadata for {img}; skipping")
            continue
        stem = Path(img).stem
        out_dir = os.path.join(pred_root, stem)
        processed.append(img)
        if img in done:
            if on_image_done is not None:
                on_image_done(img)
            continue
        if predictor is None:  # lazy: skip model load when fully recovered
            from treedetection_tpu_torch.prediction import get_predictor
            predictor = get_predictor(config, model_path)
        meta_path = os.path.join(tiles_dir, f"{stem}.json")
        n = predictor(img, meta_path, out_dir, exclude_flag)
        completed.append(img)
        recoveries.save_prediction_recovery_data(pred_root, model_path, completed)
        if logger:
            logger.info(f"Predicted {n} tiles for {stem} ({i + 1}/{len(images)})")
        if on_image_done is not None:
            on_image_done(img)
    return processed


def predict_tiles(config: Dict[str, Any], on_image_done=None) -> List[str]:
    """Model inference + stitching (+ two-model fusion) — reference
    ``detection.py:134-253``.  Returns the stitched per-image GPKG paths.

    ``on_image_done`` is honored on the single-model branch only (the
    two-model branch fuses per image pairs across two full passes, so
    per-image downstream work has no correct hook point)."""
    Config()._load_into_config(config)
    logger = config.get("logger")
    t0 = time.time()
    images, heights = _list_images(config)
    pairs = match_image_heights(config, images, heights)
    images = list(pairs.keys())
    pred_root = _predictions_dir(config)

    two_model = (config.get("urban_model") and config.get("forrest_model")
                 and config.get("forrest_outline"))
    if two_model:
        from treedetection_tpu_torch.fusion import fuse_predictions
        urban_root = os.path.join(pred_root, "urban")
        forest_root = os.path.join(pred_root, "forest")
        predict_on_model(config, config["urban_model"], images,
                         "only_forest", urban_root)
        urban_gpkgs = process_and_stitch_predictions(
            config, urban_root, images)
        predict_on_model(config, config["forrest_model"], images,
                         "only_urban", forest_root)
        forest_gpkgs = process_and_stitch_predictions(
            config, forest_root, images)
        outputs = fuse_predictions(config, urban_gpkgs, forest_gpkgs,
                                   config["forrest_outline"], pred_root)
    else:
        predict_on_model(config, config.get("combined_model", ""), images,
                         None, pred_root, on_image_done=on_image_done)
        outputs = process_and_stitch_predictions(config, pred_root, images)
    if logger:
        logger.debug(f"predict_tiles took {time.time() - t0:.1f}s")
    return outputs


def _predict_postprocess_overlapped(config: Dict[str, Any]) -> List[str]:
    """Single-host single-model predict with per-file downstream overlap
    (the reference overlaps via ThreadPools, reference
    ``postprocessing.py:1051``, ``helpers.py:573-580``): while file N+1
    predicts, a background worker stitches, exclusion-filters, and
    postprocesses file N.  The worker's device work (the raster stats, the
    pairwise kernels) queues on the device's stream with the Predictor's
    batches; CUDA orders it, no lock is needed.  Every step is
    idempotent via the stage manifests — the staged ``postprocess_files``
    mop-up that follows stays correct whether or not a worker task failed,
    and re-running the stages individually still works."""
    Config()._load_into_config(config)
    logger = config.get("logger")
    t0 = time.time()
    images, heights = _list_images(config)
    pairs = match_image_heights(config, images, heights)
    images = list(pairs.keys())
    pred_root = _predictions_dir(config)

    from concurrent.futures import ThreadPoolExecutor
    pp_futures: List[Any] = []

    def _pp_one(img: str) -> None:
        from treedetection_tpu_torch.fusion import exclude_outlines
        from treedetection_tpu_torch.postprocessing import (
            process_files_in_directory)
        gpkgs = process_and_stitch_predictions(config, pred_root, [img])
        exclude_outlines([p for p in gpkgs if os.path.exists(p)],
                         config.get("exclude_files", []), logger)
        process_files_in_directory(config, pred_root, images, heights,
                                   out_dir=config["output_directory"])

    with ThreadPoolExecutor(max_workers=1,
                            thread_name_prefix="td-overlap-pp") as pool:
        predict_on_model(
            config, config.get("combined_model", ""), images, None,
            pred_root,
            on_image_done=lambda img: pp_futures.append(
                pool.submit(_pp_one, img)))
        for f in pp_futures:
            try:
                f.result()
            except Exception as exc:  # staged mop-up below redoes the file
                if logger:
                    logger.error(f"Overlapped postprocess failed: {exc}")
    # bulk stitch AFTER all workers joined (manifest no-op when the workers
    # covered everything; the safety net for eager-sink evictions)
    outputs = process_and_stitch_predictions(config, pred_root, images)
    if logger:
        logger.debug(f"overlapped predict+postprocess took "
                     f"{time.time() - t0:.1f}s")
    return outputs


# --- stage 3 ----------------------------------------------------------------

def postprocess_files(config: Dict[str, Any]) -> List[str]:
    """Exclusion masking + crown filtering + final copy (reference
    ``detection.py:23-59``)."""
    Config()._load_into_config(config)
    from treedetection_tpu_torch.fusion import exclude_outlines
    from treedetection_tpu_torch.postprocessing import process_files_in_directory
    logger = config.get("logger")
    pred_root = _predictions_dir(config)
    images, heights = _list_images(config)

    stitched = sorted(glob.glob(os.path.join(pred_root, "*.gpkg")))
    only_stems = all_stems = None
    orphan_owner = True
    index_images = images
    if current_num_hosts() > 1:
        # each stitched layer is postprocessed by exactly ONE host (the one
        # owning its image in the partition); host 0 takes the layers no
        # host's image names
        images_full, _ = _list_images(config, partition=False)
        index_images = images_full  # the raster index may need any raster
        only_stems = {Path(p).stem for p in images}
        all_stems = {Path(p).stem for p in images_full}
        orphan_owner = current_host_id() == 0
        stitched = [p for p in stitched
                    if Path(p).stem in only_stems
                    or (orphan_owner and Path(p).stem not in all_stems)]
    exclude_outlines(stitched, config.get("exclude_files", []), logger)
    processed = process_files_in_directory(
        config, pred_root, index_images, heights,
        out_dir=config["output_directory"],
        only_stems=only_stems, all_stems=all_stems,
        orphan_owner=orphan_owner)

    # final copy (reference detection.py:46-59)
    out_root = config["output_directory"]
    if config.get("timestamped_output_directory"):
        out_root = os.path.join(out_root, time.strftime("%Y%m%d-%H%M%S"))
        os.makedirs(out_root, exist_ok=True)
        finals = []
        for p in processed:
            if os.path.exists(p):
                dst = os.path.join(out_root, os.path.basename(p))
                shutil.copyfile(p, dst)
                finals.append(dst)
        return finals
    return [p for p in processed if os.path.exists(p)]


# --- cleanup ------------------------------------------------------------------

def cleanup_files(config: Dict[str, Any]) -> None:
    """Delete intermediates unless keep_intermediate (reference
    ``detection.py:375-399``): tiles dir, merged dirs, prediction folders."""
    if config.get("keep_intermediate", False):
        return
    logger = config.get("logger")
    targets = [config.get("tiles_path"),
               os.path.join(config["image_directory"],
                            config.get("merged_path", "merged")),
               os.path.join(config["height_data_path"],
                            config.get("merged_path", "merged")),
               _predictions_dir(config)]
    for t in targets:
        if t and os.path.isdir(t):
            shutil.rmtree(t, ignore_errors=True)
            if logger:
                logger.debug(f"Removed intermediate directory {t}")


# --- end-to-end ----------------------------------------------------------------

def process_files(config: Dict[str, Any]) -> List[str]:
    """Full pipeline with per-stage timing (reference ``detection.py:342-373``)."""
    Config()._load_into_config(config)
    logger = config.get("logger")
    ensure_distributed(config, logger)
    LAST_BARRIER_SECONDS.clear()
    LAST_MULTIHOST_TOTALS.clear()
    t0 = time.time()
    preprocess_files(config)
    # a host's predict stage may take images that another host tiled (and
    # seam strips another host wrote): all preprocessing must be on shared
    # storage before any host reads it
    _multihost_barrier("preprocess_done", logger)
    t1 = time.time()
    # Overlapped predict/postprocess: file N's stitch + postprocess runs on
    # a background worker while file N+1 predicts.  Every step is idempotent
    # via the stage manifests, so the staged mop-up below stays correct
    # whether or not overlap ran.  Single-model only: two-model fusion needs
    # the full predict pass first.
    two_model = (config.get("urban_model") and config.get("forrest_model")
                 and config.get("forrest_outline"))
    overlap = (config.get("overlap_postprocess", True) and not two_model
               and current_num_hosts() == 1)
    if overlap:
        _predict_postprocess_overlapped(config)
    else:
        predict_tiles(config)
    _multihost_barrier("predict_done", logger)
    t2 = time.time()
    outputs = postprocess_files(config)
    t3 = time.time()
    cleanup_files(config)
    t4 = time.time()
    LAST_STAGE_SECONDS.clear()
    LAST_STAGE_SECONDS.update(preprocess=t1 - t0, predict=t2 - t1,
                              postprocess=t3 - t2, cleanup=t4 - t3,
                              total=t4 - t0)
    if logger:
        logger.debug(
            f"Timing: preprocess {t1 - t0:.1f}s, predict {t2 - t1:.1f}s, "
            f"postprocess {t3 - t2:.1f}s, cleanup {t4 - t3:.1f}s, "
            f"total {t4 - t0:.1f}s")
    _log_multihost_totals(outputs, logger)
    return outputs


def _multihost_barrier(name: str, logger) -> None:
    """Block until every process of the ``torch.distributed`` group reaches
    this point, and record the seconds waited in ``LAST_BARRIER_SECONDS``.
    A no-op without a group of more than one process, as in the
    environment-variable simulation, whose hosts run one after another
    (which is itself a barrier)."""
    if process_count() <= 1:
        return
    import torch.distributed as dist
    t0 = time.time()
    try:
        dist.barrier()
    except RuntimeError as exc:  # a failed barrier must not kill the run
        if logger:
            logger.warning(f"Cross-host barrier {name} failed: {exc}")
    LAST_BARRIER_SECONDS[name] = time.time() - t0


def _log_multihost_totals(outputs: List[str], logger) -> None:
    """On a multi-process run, all-gather each host's (files, crowns)
    totals so that every host logs the run's counts."""
    if process_count() <= 1:
        return
    import torch
    import torch.distributed as dist
    from treedetection_tpu_torch.vector import read_gpkg
    crowns = sum(len(read_gpkg(p)[0]) for p in outputs if os.path.exists(p))
    mine = torch.tensor([len(outputs), crowns], dtype=torch.int64)
    try:
        totals = [torch.zeros_like(mine) for _ in range(process_count())]
        dist.all_gather(totals, mine)
    except RuntimeError as exc:  # a failed collective must not kill outputs
        if logger:
            logger.warning(f"Cross-host metric reduction failed: {exc}")
        return
    LAST_MULTIHOST_TOTALS[:] = [t.tolist() for t in totals]
    if logger:
        files = sum(int(t[0]) for t in totals)
        all_crowns = sum(int(t[1]) for t in totals)
        logger.info(f"Multi-host totals: {files} files, {all_crowns} crowns "
                    f"across {len(totals)} hosts (this host: "
                    f"{len(outputs)}/{crowns})")


if __name__ == "__main__":
    import sys
    from treedetection_tpu_torch.config import get_config
    cfg_path = sys.argv[1] if len(sys.argv) > 1 else "config.yml"
    cfg, _ = get_config(cfg_path)
    process_files(cfg)
