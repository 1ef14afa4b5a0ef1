"""Checkpoint/resume manifests for every pipeline stage.

The reference's five YAML-manifest resume mechanisms (SURVEY §5;
reference ``recoveries.py``, ``preprocessing.py:226-278``,
``postprocessing.py:827-874``) are preserved here as one unified module —
county runs take days and every stage must be independently resumable by
diffing the filesystem against its manifest.

Multi-host note: under a sharded run each host owns a disjoint file subset,
writes ``<name>.<host_id>.yaml`` manifests, and readers merge all shards —
manifests never race because shard files are single-writer.

The manifests are YAML of one flat shape; they are read and written through
``flatyaml`` (no PyYAML), and interoperate with the files the JAX package
writes with ``yaml.safe_dump``.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, List, Optional

from treedetection_tpu_torch import flatyaml


def _shard_suffix() -> str:
    """Manifest shard id: ``TREEDETECTION_HOST_ID``, else the
    ``torch.distributed`` rank when a group of more than one process is
    initialised, else none (single-host).

    It reads the group's state only and initialises neither CUDA nor a
    group.  Without the rank, every host of a torchrun launch that does not
    set the variable would write the SAME manifest path, and the last
    writer would drop the other hosts' progress."""
    host = os.environ.get("TREEDETECTION_HOST_ID")
    if host is None:
        from treedetection_tpu_torch.parallel.mesh import (
            process_count, process_index)
        if process_count() > 1:
            host = str(process_index())
    return f".{host}" if host else ""


def _manifest_paths(directory: str, name: str) -> List[str]:
    return sorted(glob.glob(os.path.join(directory, f"{name}*.yaml")))


def _manifest_write_path(directory: str, name: str) -> str:
    return os.path.join(directory, f"{name}{_shard_suffix()}.yaml")


def _load_merged(directory: str, name: str) -> Dict[str, Any]:
    merged: Dict[str, Any] = {}
    for path in _manifest_paths(directory, name):
        try:
            data = flatyaml.load(path) or {}
        except flatyaml.FlatYamlError:
            continue
        for key, value in data.items():
            if isinstance(value, list) and isinstance(merged.get(key), list):
                merged[key] = sorted(set(merged[key]) | set(value))
            elif isinstance(value, dict) and isinstance(merged.get(key), dict):
                merged[key].update(value)
            else:
                merged[key] = value
    return merged


def _save(directory: str, name: str, data: Dict[str, Any]) -> None:
    os.makedirs(directory, exist_ok=True)
    path = _manifest_write_path(directory, name)
    tmp = path + ".tmp"
    flatyaml.dump(data, tmp)
    os.replace(tmp, path)


# --- prediction (reference recoveries.py:146-249) --------------------------

def load_prediction_recovery_data(output_dir: str, model_path: str,
                                  tile_meta_by_image: Optional[Dict[str, Dict]] = None,
                                  exclude_flag: Optional[str] = None) -> List[str]:
    """Images whose predictions are complete for this model.

    An image counts as done when the manifest lists it AND its prediction
    folder holds at least as many ``Prediction_*.json`` files as non-excluded
    tiles in its tile-metadata (the reference's count-validation with
    exclude-flag awareness, ``recoveries.py:146-214``).  Manifest resets when
    ``model_path`` differs.
    """
    data = _load_merged(output_dir, "prediction_recovery")
    if data.get("model_path") != model_path:
        return []
    done: List[str] = []
    for image in data.get("processed_images", []):
        stem = os.path.splitext(os.path.basename(image))[0]
        pred_dir = os.path.join(output_dir, stem)
        if not os.path.isdir(pred_dir):
            continue
        n_files = len(glob.glob(os.path.join(pred_dir, "Prediction_*.json")))
        if tile_meta_by_image and image in tile_meta_by_image:
            tiles = tile_meta_by_image[image]
            expected = sum(
                1 for meta in tiles.values()
                if not (exclude_flag and meta.get(exclude_flag, False)))
            if n_files < expected:
                continue
        elif n_files == 0:
            continue
        done.append(image)
    return done


def save_prediction_recovery_data(output_dir: str, model_path: str,
                                  processed_images: List[str]) -> None:
    _save(output_dir, "prediction_recovery",
          {"model_path": model_path, "processed_images": sorted(set(processed_images))})


# --- stitching (reference recoveries.py:111-144) ---------------------------

def load_stitching_recovery_data(output_dir: str) -> List[str]:
    return list(_load_merged(output_dir, "stitching_recovery").get("completed", []))


def save_stitching_recovery_data(output_dir: str, completed: List[str]) -> None:
    _save(output_dir, "stitching_recovery", {"completed": sorted(set(completed))})


# --- fusion (reference recoveries.py:251-284) ------------------------------

def load_fusion_recovery_data(output_dir: str) -> List[str]:
    return list(_load_merged(output_dir, "fusion_recovery").get("completed", []))


def save_fusion_recovery_data(output_dir: str, completed: List[str]) -> None:
    _save(output_dir, "fusion_recovery", {"completed": sorted(set(completed))})


# --- postprocess (reference postprocessing.py:827-874) ---------------------

POSTPROCESS_PARAM_KEYS = (
    "confidence_threshold", "containment_threshold", "height_threshold",
    "ndvi_mean_threshold", "ndvi_var_threshold", "iou_threshold",
    "area_threshold", "ndvi_scaling_factor", "height_scaling_factor",
)


def postprocess_params(config: Dict[str, Any]) -> Dict[str, Any]:
    return {k: config.get(k) for k in POSTPROCESS_PARAM_KEYS}


def load_postprocess_recovery_data(output_dir: str, params: Dict[str, Any]) -> List[str]:
    """Completed files IF the full threshold-parameter dict matches; any
    mismatch resets (reference ``postprocessing.py:827-860``)."""
    data = _load_merged(output_dir, "recovery")
    if data.get("params") != params:
        return []
    return list(data.get("completed", []))


def save_postprocess_recovery_data(output_dir: str, params: Dict[str, Any],
                                   completed: List[str]) -> None:
    _save(output_dir, "recovery", {"params": params, "completed": sorted(set(completed))})


# --- continue file (reference config.py:188, detection.py:282-285) ---------

def load_continue_file(path: Optional[str]) -> List[str]:
    """Global skip-list consulted before preprocessing."""
    if not path or not os.path.exists(path):
        return []
    try:
        data = flatyaml.load(path) or {}
    except flatyaml.FlatYamlError:
        return []
    if isinstance(data, list):
        return [str(x) for x in data]
    return [str(x) for x in data.get("skip", [])]
