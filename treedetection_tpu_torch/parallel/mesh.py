"""Devices, batch sharding and host identity for multi-device and multi-host
runs (counterpart of ``treedetection_tpu/parallel/mesh.py``).

The JAX package builds a 1-D ``Mesh`` and lets XLA place the shards.  Here a
mesh is the list of ``torch.device``s a Predictor splits its batches over,
and :func:`sharded_forward` places the work: equal chunks in tile order, one
model replica and one CUDA stream per device.

Host identity comes from ``TREEDETECTION_NUM_HOSTS`` /
``TREEDETECTION_HOST_ID`` first (the stage-by-stage simulation, and
launchers that do not use ``torch.distributed``), else from the default
process group that :func:`ensure_distributed` initialises under torchrun.
"""

from __future__ import annotations

import copy
import datetime
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from treedetection_tpu_torch.config import select_device, select_devices


# How long a barrier waits for the slowest host: a stage of a county run can
# take days, and gloo's default of 30 minutes would end the wait before the
# stage does.
STAGE_TIMEOUT = datetime.timedelta(days=7)


def process_count() -> int:
    """Processes of the ``torch.distributed`` run: the default group's
    size, 1 when no group is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank in the default group, 0 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def current_num_hosts() -> int:
    """Hosts of this run: ``TREEDETECTION_NUM_HOSTS``, else the process
    count."""
    return int(os.environ.get("TREEDETECTION_NUM_HOSTS", 0)) or \
        process_count()


def current_host_id() -> int:
    """This host's id: ``TREEDETECTION_HOST_ID``, else the process rank."""
    return int(os.environ.get("TREEDETECTION_HOST_ID", process_index()))


def partition_files(files: Sequence[str], host_id: Optional[int] = None,
                    num_hosts: Optional[int] = None) -> List[str]:
    """Deterministic per-host slice of the work list: ``sorted(files)[i]``
    with ``i % num_hosts == host_id``."""
    if num_hosts is None:
        num_hosts = current_num_hosts()
    if host_id is None:
        host_id = current_host_id()
    ordered = sorted(files)
    return [f for i, f in enumerate(ordered)
            if i % max(num_hosts, 1) == host_id]


def ensure_distributed(config: Optional[Dict[str, Any]] = None,
                       logger=None) -> bool:
    """Initialise ``torch.distributed`` once for a multi-host run (the
    counterpart of ``jax.distributed.initialize``).

    Triggered by ``multihost: true`` in the config or a launcher's
    environment with ``WORLD_SIZE`` > 1 (torchrun: ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``); a no-op otherwise.  The
    group is gloo: it carries barriers and two int64 totals, while the data
    moves through shared storage.  A failed initialisation warns and the
    run goes on single-host.  Returns True when running multi-process."""
    if process_count() > 1:
        return True
    want = bool((config or {}).get("multihost")) or \
        int(os.environ.get("WORLD_SIZE") or 1) > 1
    if not want or dist.is_initialized():
        return False
    try:
        dist.init_process_group("gloo", timeout=STAGE_TIMEOUT)
    except (RuntimeError, ValueError) as exc:
        if logger:
            logger.warning(f"torch.distributed.init_process_group failed: "
                           f"{exc}; continuing single-host")
        return False
    return process_count() > 1


def make_mesh(config: Optional[Dict[str, Any]] = None,
              devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices a Predictor splits its batches over: ``devices``, else
    ``config["devices"]``, else those that ``config["device"]`` selects
    (``config.select_devices``); ``mesh_shape: {axis: n}`` keeps the first
    n.  Tile inference is data-parallel only, so the mesh is 1-D."""
    config = config or {}
    if devices is None:
        devices = config.get("devices")
    devs = ([select_device(d) for d in devices] if devices
            else select_devices(config.get("device", "cuda")))
    mesh_shape = config.get("mesh_shape")
    if isinstance(mesh_shape, dict) and mesh_shape:
        devs = devs[:int(mesh_shape[next(iter(mesh_shape))])]
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"a mesh of one device type, got {devs}")
    return devs


def replicate(module: torch.nn.Module,
              devices: Sequence[torch.device]) -> List[torch.nn.Module]:
    """One replica of ``module`` per device entry: the module itself on the
    first (where the caller put it), copies on the others."""
    return [module] + [copy.deepcopy(module).to(d) for d in devices[1:]]


def shard_batch(batch: torch.Tensor, n: int) -> List[torch.Tensor]:
    """The leading dimension in ``n`` equal chunks, in order."""
    if batch.shape[0] % n:
        raise ValueError(f"a batch of {batch.shape[0]} does not split into "
                         f"{n} equal chunks")
    return list(batch.split(batch.shape[0] // n))


def _recorded_event(device: torch.device) -> Optional[torch.cuda.Event]:
    """An event on the device's current stream, None on the CPU."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def sharded_forward(fn: Callable[..., Any],
                    replicas: Sequence[torch.nn.Module],
                    devices: Sequence[torch.device]
                    ) -> Callable[..., List[Tuple[Any, Any]]]:
    """-> ``forward(batch, *args)``: ``fn(replica, device, chunk, *args)``
    for each device's equal chunk of the batch, and ``[(result, event)]`` in
    tile order, ``event`` recorded after fn's work on its stream (None on
    the CPU).  With one device fn runs on the caller's thread and current
    stream.  With more, each runs from a thread of its own, on CUDA on the
    device's own stream, so that the host work inside one chunk's forward
    (its syncs) overlaps the others'."""
    if len(devices) == 1:
        def forward_one(batch, *args):
            out = fn(replicas[0], devices[0], batch, *args)
            return [(out, _recorded_event(devices[0]))]
        return forward_one
    streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None
               for d in devices]
    pool = ThreadPoolExecutor(max_workers=len(devices),
                              thread_name_prefix="td-shard")

    def run(i, chunk, args):
        if streams[i] is None:
            return fn(replicas[i], devices[i], chunk, *args), None
        with torch.cuda.stream(streams[i]):
            out = fn(replicas[i], devices[i], chunk, *args)
            return out, _recorded_event(devices[i])

    def forward(batch, *args):
        futures = [pool.submit(run, i, chunk, args) for i, chunk in
                   enumerate(shard_batch(batch, len(devices)))]
        return [f.result() for f in futures]
    return forward
