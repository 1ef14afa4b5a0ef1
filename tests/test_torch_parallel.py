"""Multi-host and multi-device runs of the port (``parallel/``), on the CPU:
the file partition against the JAX package's, the manifest shard rule, two
hosts simulated stage by stage through ``TREEDETECTION_NUM_HOSTS`` /
``TREEDETECTION_HOST_ID`` (seam strips and who tiled them against the JAX
package's two-host run), a real two-process ``torch.distributed`` run of
``process_files`` over gloo, and the Predictor split over two devices.

Crowns come from the trained weights (``example/data/model_full.npz``) on
rasters painted with crown-like discs, so no comparison is vacuous.  Every
run of the port compared here is deterministic on the CPU (the forward gives
each tile the same bits at any batch size), so crowns are compared as exact
multisets.  Every spawned process has its own timeout and fails the test
when it runs out."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import yaml

from treedetection_tpu_torch import detection, native, recoveries
from treedetection_tpu_torch.config import Config, prepare_config
from treedetection_tpu_torch.geo import Affine, write_geotiff
from treedetection_tpu_torch.parallel import mesh
from treedetection_tpu_torch.vector import read_gpkg

REPO = Path(__file__).resolve().parents[1]
NPZ = REPO / "example" / "data" / "model_full.npz"
PIXEL = 0.2
SIDE_PX = 500                      # 100 m sheets: 16 tiles of 25 m each
SPAWN_TIMEOUT_S = 120
HOST_ENV = ("TREEDETECTION_NUM_HOSTS", "TREEDETECTION_HOST_ID")


def _write_sheet(root: Path, name: str, origin, seed: int) -> None:
    """RGBI at 0.2 m with crown-like discs (dark red/blue, bright NIR) and a
    1 m nDSM with the discs 5-25 m high."""
    rng = np.random.default_rng(seed)
    h = w = SIDE_PX
    img = rng.normal([150, 160, 120, 110], [12, 12, 12, 10],
                     (h, w, 4)).astype(np.float32)
    ndsm = np.zeros((h // 5, w // 5), dtype=np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    myy, mxx = np.mgrid[0:h // 5, 0:w // 5]
    for _ in range(112):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        rad = rng.uniform(2.0, 6.0) / PIXEL
        d2 = ((yy - cy) ** 2 + (xx - cx) ** 2) / rad ** 2
        inside = d2 < 1.0
        shade = 0.55 + 0.3 * d2[inside]
        img[inside, 0] *= shade * 0.6
        img[inside, 1] *= shade * 0.85
        img[inside, 2] *= shade * 0.6
        img[inside, 3] = np.minimum(img[inside, 3] * 1.8, 255)
        md2 = ((myy + 0.5 - cy / 5) ** 2 + (mxx + 0.5 - cx / 5) ** 2) \
            / (rad / 5) ** 2
        ndsm = np.maximum(ndsm, np.where(md2 < 1.0,
                                         rng.uniform(5, 25) * (1 - 0.5 * md2),
                                         0.0).astype(np.float32))
    write_geotiff(str(root / "rgb" / name),
                  np.clip(img, 0, 255).astype(np.uint8),
                  Affine.from_origin(*origin, PIXEL, PIXEL), crs=25832)
    write_geotiff(str(root / "nDSM" / name), ndsm,
                  Affine.from_origin(*origin, 1.0, 1.0), crs=25832,
                  nodata=-9999.0)


def _write_grid(root: Path, nx: int = 2, ny: int = 1) -> None:
    """nx x ny adjacent sheets (right and down neighbours) with their nDSM
    twins: ``tests/test_multihost.py``'s layout, at 0.2 m with crowns."""
    (root / "rgb").mkdir(parents=True)
    (root / "nDSM").mkdir(parents=True)
    side_m = SIDE_PX * PIXEL
    for i in range(nx * ny):
        iy, ix = divmod(i, nx)
        _write_sheet(root, f"{324125317 + i}.tif",
                     (412000.0 + side_m * ix, 5318000.0 - side_m * iy),
                     seed=i)


def _raw_config(**over):
    cfg = {"image_directory": "rgb", "height_data_path": "nDSM",
           "combined_model": str(NPZ), "output_directory": "out",
           "tiles_path": "tiles",
           "tile_width": 25, "tile_height": 25, "buffer": 0,
           "batch_size": 2, "use_overlap": True, "merged_path": "merged",
           "overlapping_tiles_width": 1, "overlapping_tiles_height": 1,
           # seam strips: rgbi {base}_{x1}_{y1}_{x2}_{y2}_{end}.tif, height
           # {base}_{x1y1x2y2}_{end}.tif; postprocessing looks a layer's
           # height raster up by the IMAGE's stem, so the height regex
           # accepts both spellings
           "image_merged_regex": r"(\d+)_(\d+)_(\d+)_(\d+)_(\d+)_\d+\.tif",
           "height_data_merged_regex":
               r"(\d+)_(\d+)_?(\d*)_?(\d*)_?(\d*)_\d+\.tif",
           "num_workers": 2, "model_depth": 50, "model_input_size": 256,
           "pixel_std": [57.375, 57.12, 58.395],
           "rpn_pre_nms_topk": 300, "rpn_post_nms_topk": 150,
           "rpn_approx_topk_from": 0, "max_detections": 40,
           "ndvi_mean_threshold": 0.1, "ndvi_var_threshold": 0.2,
           "mixed_precision": False, "keep_intermediate": True,
           "device": "cpu", "compile_warmup": False}
    cfg.update(over)
    return cfg


def _prepared(root: Path):
    Config.reset()
    return prepare_config(_raw_config(), str(root))[0]


def _close_logger(config) -> None:
    for handler in list(config["logger"].handlers):
        config["logger"].removeHandler(handler)
        handler.close()


def _run_stage(stage, root: Path, monkeypatch, host=None, hosts=None):
    """One stage of the port on ``root``, as one simulated host (or
    single-host with ``hosts`` None)."""
    for name, value in zip(HOST_ENV, (hosts, host)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, str(value))
    config = _prepared(root)
    try:
        return stage(config)
    finally:
        _close_logger(config)


def _crown_multiset(out_dir: Path):
    """Every processed crown under ``out_dir`` as a sorted list of (layer,
    rounded ring, properties)."""
    rows = []
    for p in sorted(out_dir.glob("processed_*.gpkg")):
        geoms, props, srs = read_gpkg(str(p))
        assert srs == 25832
        for g, q in zip(geoms, props):
            ring = tuple(map(tuple, np.round(np.asarray(g[0][0]),
                                             4).tolist()))
            rows.append((p.name, ring, tuple(sorted(
                (k, round(v, 4) if isinstance(v, float) else v)
                for k, v in q.items()))))
    return sorted(rows)


def _strip_names(root: Path):
    return (sorted(p.name for p in (root / "rgb" / "merged").glob("*.tif"))
            + sorted(p.name for p in (root / "nDSM" / "merged").glob("*.tif")))


def _tiled(root: Path):
    return {p.stem for p in (root / "tiles").glob("*.json")}


@pytest.fixture(autouse=True)
def _single_host_env(monkeypatch):
    for name in HOST_ENV + ("WORLD_SIZE", "RANK", "LOCAL_WORLD_SIZE",
                            "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def single_host(tmp_path_factory):
    """The port's single-host ``process_files`` on the 2 x 1 grid."""
    root = tmp_path_factory.mktemp("single")
    _write_grid(root)
    for name in HOST_ENV:
        os.environ.pop(name, None)
    os.environ.pop("TD_PAIRS_DEVICE", None)
    config = _prepared(root)
    try:
        detection.process_files(config)
    finally:
        _close_logger(config)
    crowns = _crown_multiset(root / "out")
    assert len(crowns) >= 10, "too few crowns: the comparison is vacuous"
    return {"root": root, "crowns": crowns}


# --- (a) the file partition --------------------------------------------------

@pytest.mark.parametrize("num_hosts", range(1, 9))
def test_partition_files_equals_jax(num_hosts):
    """The same deterministic slices as the JAX package's partition_files
    for seeded file lists, every host id, and the slices cover the list
    once."""
    from treedetection_tpu.parallel import partition_files as jax_partition
    rng = np.random.default_rng(num_hosts)
    for n_files in (0, 1, 7, 23):
        files = [f"/data/rgb/{int(v)}.tif" for v in
                 rng.integers(324000000, 325000000, n_files)]
        slices = []
        for host in range(num_hosts):
            ours = mesh.partition_files(files, host_id=host,
                                        num_hosts=num_hosts)
            assert ours == jax_partition(files, host_id=host,
                                         num_hosts=num_hosts)
            slices += ours
        assert sorted(slices) == sorted(files)


def test_partition_files_reads_the_environment(monkeypatch):
    files = [f"{i}.tif" for i in range(5)]
    assert mesh.partition_files(files) == sorted(files)      # one host
    monkeypatch.setenv("TREEDETECTION_NUM_HOSTS", "2")
    monkeypatch.setenv("TREEDETECTION_HOST_ID", "1")
    assert mesh.partition_files(files) == ["1.tif", "3.tif"]
    assert mesh.current_num_hosts() == 2


# --- (b) the manifest shard rule ---------------------------------------------

def test_shard_suffix_env_then_rank_then_none(monkeypatch, tmp_path):
    """``TREEDETECTION_HOST_ID`` wins; else the rank of an initialised group
    of more than one process; else no suffix.  A real gloo group of one
    process gives no suffix; a group of two is faked here and run for real
    in ``test_two_processes_match_single_host``."""
    assert recoveries._shard_suffix() == ""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        assert mesh.process_count() == 1
        assert recoveries._shard_suffix() == ""
    finally:
        dist.destroy_process_group()
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(dist, "get_rank", lambda: 2)
    assert recoveries._shard_suffix() == ".2"
    monkeypatch.setenv("TREEDETECTION_HOST_ID", "7")
    assert recoveries._shard_suffix() == ".7"


def test_ensure_distributed_is_a_no_op_or_warns(caplog):
    """No multi-host request: nothing is initialised.  ``multihost: true``
    without a launcher's environment: a warning, and the run goes on
    single-host (the JAX package's behaviour)."""
    import logging
    logger = logging.getLogger("test_torch_parallel")
    assert mesh.ensure_distributed({}, logger) is False
    with caplog.at_level(logging.WARNING, logger="test_torch_parallel"):
        assert mesh.ensure_distributed({"multihost": True}, logger) is False
    assert "continuing single-host" in caplog.text
    assert not dist.is_initialized()


# --- (c) two hosts simulated stage by stage ----------------------------------

def test_two_simulated_hosts_match_single_host_and_jax(single_host, tmp_path,
                                                       monkeypatch):
    """Two hosts through the environment variables, stage by stage (the
    sequence is the barrier): the union of their processed crowns EQUALS
    the single-host run's, and the seam strips, and which host tiled each
    raster, equal the JAX package's two-host preprocessing on the same
    grid."""
    from treedetection_tpu.config import Config as JaxConfig
    from treedetection_tpu.config import get_config as jax_get_config
    from treedetection_tpu.detection import (
        preprocess_files as jax_preprocess)
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    _write_grid(ours)
    _write_grid(theirs)
    tiled_by = {}
    for stage in (detection.preprocess_files, detection.predict_tiles,
                  detection.postprocess_files):
        for host in (0, 1):
            before = _tiled(ours)
            _run_stage(stage, ours, monkeypatch, host, 2)
            tiled_by.update({s: host for s in _tiled(ours) - before})
    cfg_path = theirs / "config.yml"
    cfg_path.write_text(yaml.safe_dump(_raw_config()))
    jax_tiled_by = {}
    for host in (0, 1):
        monkeypatch.setenv("TREEDETECTION_NUM_HOSTS", "2")
        monkeypatch.setenv("TREEDETECTION_HOST_ID", str(host))
        JaxConfig.reset()
        config, _ = jax_get_config(str(cfg_path))
        before = _tiled(theirs)
        jax_preprocess(config)
        jax_tiled_by.update({s: host for s in _tiled(theirs) - before})
    strips = _strip_names(ours)
    assert len(strips) == 2
    assert strips == _strip_names(theirs) == _strip_names(single_host["root"])
    assert tiled_by == jax_tiled_by
    # host 0 owns the left sheet and so its seam strip; host 1 the right
    strip = next(s for s in strips if s.count("_") == 5)[:-len(".tif")]
    assert tiled_by == {"324125317": 0, strip: 0, "324125318": 1}
    assert _crown_multiset(ours / "out") == single_host["crowns"]
    # each host wrote its own postprocess manifest shard
    assert {p.name for p in (ours / "out").glob("recovery.*.yaml")} == \
        {"recovery.0.yaml", "recovery.1.yaml"}


# --- (d) two real processes over gloo ----------------------------------------

CHILD = r"""
import json, os, sys
import torch
import torch.distributed as dist
torch.set_num_threads(2)
repo, root, init, rank, world = sys.argv[1:6]
sys.path.insert(0, repo)
from treedetection_tpu_torch import detection, recoveries
from treedetection_tpu_torch.config import Config, prepare_config
from treedetection_tpu_torch.parallel import mesh
if init == "file":      # a launcher that initialises the group itself
    dist.init_process_group("gloo", init_method=f"file://{root}/rdzv",
                            rank=int(rank), world_size=int(world))
with open(os.path.join(root, "raw.json")) as fh:
    raw = json.load(fh)
config, _ = prepare_config(raw, root)
outputs = detection.process_files(config)
result = {"processes": mesh.process_count(), "rank": mesh.process_index(),
          "suffix": recoveries._shard_suffix(),
          "totals": detection.LAST_MULTIHOST_TOTALS,
          "outputs": sorted(os.path.basename(p) for p in outputs),
          "stage_s": detection.LAST_STAGE_SECONDS}
if dist.is_initialized():
    dist.destroy_process_group()
print("RESULT " + json.dumps(result), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(root: Path, init: str, world: int):
    """``world`` processes of CHILD on ``root``; -> their results and
    standard outputs, or a failed test if one fails or outlasts
    SPAWN_TIMEOUT_S."""
    env = {k: v for k, v in os.environ.items()
           if k not in HOST_ENV + ("WORLD_SIZE", "RANK", "MASTER_ADDR",
                                   "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="2", PYTHONPATH=str(REPO))
    port = str(_free_port())
    procs = []
    for rank in range(world):
        if init == "env":   # torchrun's environment: ensure_distributed
            env = dict(env, MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                       RANK=str(rank), WORLD_SIZE=str(world))
        log = open(root / f"child_{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", CHILD, str(REPO), str(root), init,
             str(rank), str(world)], cwd=str(root), env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    outs = []
    try:
        for p, log in procs:
            try:
                rc = p.wait(timeout=SPAWN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                pytest.fail(f"a child outlasted {SPAWN_TIMEOUT_S} s")
            log.close()
            text = Path(log.name).read_text()
            assert rc == 0, text[-3000:]
            outs.append(text)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    results = [json.loads(next(line[len("RESULT "):] for line in
                               text.splitlines()
                               if line.startswith("RESULT ")))
               for text in outs]
    return results, outs


@pytest.mark.parametrize("init", ["file", "env"])
def test_two_processes_match_single_host(single_host, tmp_path, init):
    """A real two-process run of ``process_files`` on the CPU, gloo
    between the processes: ``file``, a launcher that initialises the group
    itself (``file://`` rendezvous); ``env``, torchrun's environment, from
    which ``ensure_distributed`` initialises it.  The union of the
    processed crowns EQUALS the single-host run's, the manifests are sharded
    by rank, and every host logs the all-gathered totals."""
    native.build()      # built once here, loaded by the children
    root = tmp_path / "grid"
    _write_grid(root)
    (root / "raw.json").write_text(json.dumps(_raw_config()))
    results, outs = _spawn(root, init, 2)
    assert [(r["processes"], r["rank"], r["suffix"]) for r in results] == \
        [(2, 0, ".0"), (2, 1, ".1")]
    crowns = _crown_multiset(root / "out")
    assert crowns == single_host["crowns"]
    # [files, crowns] of each host, the same on both
    totals = results[0]["totals"]
    assert results[1]["totals"] == totals
    assert [t[0] for t in totals] == [len(r["outputs"]) for r in results]
    assert sum(t[1] for t in totals) == len(crowns)
    files = sum(t[0] for t in totals)
    for text in outs:
        assert f"Multi-host totals: {files} files, {len(crowns)} crowns " \
               f"across 2 hosts" in text
    assert {p.name for p in (root / "out").glob("recovery.*.yaml")} == \
        {"recovery.0.yaml", "recovery.1.yaml"}


# --- (e) the Predictor split over two devices --------------------------------

def test_mesh_from_config():
    cpu = torch.device("cpu")
    assert mesh.make_mesh({"device": "cpu"}) == [cpu]
    assert mesh.make_mesh({"devices": ["cpu", "cpu", "cpu"]}) == [cpu] * 3
    assert mesh.make_mesh({"devices": ["cpu", "cpu", "cpu"],
                           "mesh_shape": {"data": 2}}) == [cpu] * 2
    assert mesh.make_mesh(devices=["cpu"]) == [cpu]
    with pytest.raises(ValueError, match="equal chunks"):
        mesh.shard_batch(torch.zeros(3, 2), 2)
    assert [c.tolist() for c in mesh.shard_batch(torch.arange(4), 2)] == \
        [[0, 1], [2, 3]]
    config = _raw_config(devices=["cpu", "cpu"])
    assert mesh.make_mesh(config) == [cpu, cpu]


def test_predictor_split_over_two_devices_equals_one(tmp_path):
    """Two device entries (both the CPU): each batch splits into two equal
    chunks, one replica each, and the tile files EQUAL the one-device
    Predictor's byte for byte; the batch size rounds up to a multiple of
    the device count (``tests/test_parallel.py``'s check on the JAX
    Predictor)."""
    from treedetection_tpu_torch.prediction import Predictor
    from treedetection_tpu_torch.preprocessing import tile_single_file
    (tmp_path / "rgb").mkdir()
    (tmp_path / "nDSM").mkdir()
    _write_sheet(tmp_path, "324125317.tif", (412000.0, 5318000.0), seed=5)
    tif = str(tmp_path / "rgb" / "324125317.tif")
    meta = tile_single_file(tif, str(tmp_path / "tiles"), buffer=0,
                            tile_width=34, tile_height=34)
    base = {k: v for k, v in _raw_config(batch_size=3).items()
            if k not in ("image_directory", "height_data_path")}
    one = Predictor(base, str(NPZ))
    two = Predictor(dict(base, devices=["cpu", "cpu"]), str(NPZ))
    cut = Predictor(dict(base, devices=["cpu", "cpu"],
                         mesh_shape={"data": 1}), str(NPZ))
    assert (one.batch_size, two.batch_size, cut.batch_size) == (3, 4, 3)
    assert len(two.devices) == 2 and len(cut.devices) == 1
    n1 = one(tif, meta, str(tmp_path / "one"))
    n2 = two(tif, meta, str(tmp_path / "two"))
    assert n1 == n2 == 9
    files = {p.name: p.read_bytes()
             for p in sorted((tmp_path / "one").glob("Prediction_*.json"))}
    assert files == {p.name: p.read_bytes() for p in
                     sorted((tmp_path / "two").glob("Prediction_*.json"))}
    assert sum(len(json.loads(b)) for b in files.values()) >= 5, \
        "too few crowns: the comparison is vacuous"


def test_launch_counts_survive_concurrent_devices():
    """The ROI wrappers count their launches under a lock, since a Predictor
    over several devices launches from one thread per device: more threads
    than cores, a short switch interval, and no increment lost."""
    import threading
    from treedetection_tpu_torch.ops.kernels import roi_align as k
    n_threads, each = 2 * (os.cpu_count() or 4), 500
    before, old = k.launches, sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [k._count("launches") for _ in range(each)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert k.launches == before + n_threads * each
    k.launches = before
