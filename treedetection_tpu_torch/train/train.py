"""Training loop: SGD with momentum, the reference's two presets, backbone
freezing, early stopping.

Counterpart of ``treedetection_tpu/train/train.py`` on one device.  Preset
parity with the reference (``supplementary/train_foundation_model.py:179-191``):

=============== ========= ==========
preset          update    scratch
=============== ========= ==========
ims_per_batch   9         4
base_lr         0.005     0.01
max_iter        2000      2000
backbone_freeze 3 stages  3 stages
eval_period     100       100
patience        10        10 evals
=============== ========= ==========

The optimizer is optax's chain in ``torch.optim``: the gradient's global
norm clipped to 1.0 over the trainable parameters, weight decay 1e-4 added
after the clip, SGD with momentum 0.9, and the learning rate of
:func:`lr_schedule` (a linear warmup from base_lr/100, then x0.1 at 70% and
at 90% of ``max_iter``, with ``optax.join_schedules``' step offsets).
Frozen parameters (``requires_grad=False``) and the batch-norm running
statistics (buffers) are outside it.  Parameters and optimizer state stay
float32; ``MaskRCNNConfig.bf16`` runs the convs and dense layers in
bfloat16.

Over several devices (:func:`make_sharded_train_step`, ``train_model(...,
mesh=group)``) the JAX package jits the step over a mesh; here the mesh is
a ``torch.distributed`` process group, one process per device.  Each rank
runs forward and backward on its equal chunk of the global batch with batch
norm's statistics taken over the group (``models.resnet.set_sync_group``),
then one all-reduce averages the flat gradient, and every rank applies the
same update: the step computes what one device computes at the global
batch, and the replicas stay equal bit for bit.  Processes, not threads:
the statistics are exchanged in the backward pass too, also inside remat's
recomputation, and one process's autograd engine runs a device's backward
on one thread, where one replica waiting for another would block it.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

import numpy as np
import torch
import torch.distributed as dist

from treedetection_tpu_torch.models.convert import (
    save_checkpoint_npz, to_flax_params)
from treedetection_tpu_torch.models.mask_rcnn import (
    MaskRCNN, MaskRCNNConfig, create_model)
from treedetection_tpu_torch.models.resnet import set_sync_group
from treedetection_tpu_torch.ops.image import (
    TRAIN_PIXEL_STD_BGR, normalize_bgr)
from treedetection_tpu_torch.train.losses import mask_rcnn_losses

PRESETS = {
    # reference train_foundation_model.py:179-191
    "update": {"ims_per_batch": 9, "base_lr": 0.005, "max_iter": 2000,
               "backbone_freeze": 3, "eval_period": 100, "patience": 10},
    "scratch": {"ims_per_batch": 4, "base_lr": 0.01, "max_iter": 2000,
                "backbone_freeze": 3, "eval_period": 100, "patience": 10},
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    preset: str = "update"
    base_lr: float = 0.005
    max_iter: int = 2000
    ims_per_batch: int = 9
    backbone_freeze: int = 3       # freeze stem + first N-1 res stages
    eval_period: int = 100
    patience: int = 10
    momentum: float = 0.9
    weight_decay: float = 1e-4
    warmup_iters: int = 100
    clip_grad_norm: float = 1.0    # detectron2 CLIP_GRADIENTS value
    max_gt: int = 64               # static GT budget per image
    max_eval_batches: int = 8      # cap per-eval cost
    # std of the on-device normalization of uint8 shards: "torchvision" for
    # from-scratch / std-normalized checkpoints, "ones" when fine-tuning a
    # converted detectron2-caffe checkpoint (those expect std 1 inputs)
    pixel_std: str = "torchvision"

    @classmethod
    def from_preset(cls, name: str, **over) -> "TrainConfig":
        p = PRESETS[name]
        kwargs = dict(preset=name, base_lr=p["base_lr"], max_iter=p["max_iter"],
                      ims_per_batch=p["ims_per_batch"],
                      backbone_freeze=p["backbone_freeze"],
                      eval_period=p["eval_period"], patience=p["patience"])
        kwargs.update(over)  # explicit overrides win over preset values
        return cls(**kwargs)


def _frozen_prefixes(n_stages: int) -> List[str]:
    """detectron2 FREEZE_AT: 0 freezes nothing, 1 the stem, N >= 2 the stem
    and res2..res{N}."""
    out = ["backbone.bottom_up.stem."] if n_stages >= 1 else []
    out += [f"backbone.bottom_up.res{s}." for s in range(2, 1 + n_stages)]
    return out


def _freeze_mask(model: torch.nn.Module, n_stages: int) -> Set[str]:
    """Freeze the stem and the first ``n_stages - 1`` res stages (set their
    ``requires_grad`` to False, every other parameter's to True) -> the
    names of the frozen parameters."""
    prefixes = _frozen_prefixes(n_stages)
    frozen = set()
    for name, p in model.named_parameters():
        is_frozen = any(name.startswith(pfx) for pfx in prefixes)
        p.requires_grad_(not is_frozen)
        if is_frozen:
            frozen.add(name)
    return frozen


def lr_schedule(tc: TrainConfig) -> Callable[[int], float]:
    """The learning rate of update ``step`` (0-based), as optax's
    ``join_schedules([linear_schedule(base/100, base, warmup),
    piecewise_constant_schedule(base, {b1: 0.1, b2: 0.1})], [warmup])``
    computes it, in float32 with its operations in its order (the warmup's
    multiply-add fused, rounded once, as XLA compiles it): the decay
    schedule sees ``step - warmup``, so its boundaries are the 70% and 90%
    points less the warmup."""
    f32 = np.float32
    base, warm = tc.base_lr, tc.warmup_iters
    b1 = max(int(tc.max_iter * 0.7) - warm, 1)
    b2 = max(int(tc.max_iter * 0.9) - warm, 2)
    init = base / 100

    def lr(step: int) -> float:
        if step < warm:
            frac = f32(1) - f32(min(max(step, 0), warm)) / f32(warm)
            # float64 holds the float32 product exactly: one rounding
            return float(f32(float(f32(init - base)) * float(frac)
                             + float(f32(base))))
        count = step - warm
        v = f32(base)
        for b in (b1, b2):
            if count >= b:
                v = f32(0.1) * v
        return float(v)

    return lr


class TrainOptimizer:
    """optax's ``clip_by_global_norm -> add_decayed_weights -> sgd(schedule,
    momentum)`` over the trainable parameters, in ``torch.optim.SGD`` (which
    adds the decay before its momentum, after the clip here)."""

    def __init__(self, tc: TrainConfig, params: List[torch.nn.Parameter]):
        self.tc = tc
        self.params = params
        self.lr = lr_schedule(tc)
        self.sgd = torch.optim.SGD(params, lr=self.lr(0),
                                   momentum=tc.momentum,
                                   weight_decay=tc.weight_decay)
        self.count = 0

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    def step(self) -> None:
        for p in self.params:      # optax decays a parameter without a gradient
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        # the global norm from sums of squares: torch's float32 vector_norm
        # on the CPU loses ~5e-4 relative on a tensor of 1e7 entries
        grads = [p.grad for p in self.params]
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        max_norm = self.tc.clip_grad_norm
        scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
        for g in grads:
            g.mul_(scale)
        for group in self.sgd.param_groups:
            group["lr"] = self.lr(self.count)
        self.sgd.step()
        self.count += 1


def make_optimizer(tc: TrainConfig, model: torch.nn.Module) -> TrainOptimizer:
    """Freeze ``tc.backbone_freeze`` stages (:func:`_freeze_mask`) and build
    the optimizer over the parameters left trainable."""
    _freeze_mask(model, tc.backbone_freeze)
    return TrainOptimizer(tc, [p for p in model.parameters()
                               if p.requires_grad])


def _prep_batch(batch: Dict[str, torch.Tensor], pixel_std: str = "torchvision"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device-side input prep: uint8 raw-RGB shards are normalized here (BGR
    order, caffe means, the configured std: "torchvision" or "ones"), float
    shards pass through; masks become float32."""
    img = batch["image"]
    if img.dtype == torch.uint8:
        std = (TRAIN_PIXEL_STD_BGR if pixel_std == "torchvision"
               else (1.0, 1.0, 1.0))
        img = normalize_bgr(img, pixel_std=std)
    return img, batch["masks"].to(torch.float32)


def load_batch_stats(model: torch.nn.Module,
                     state: Dict[str, torch.Tensor]) -> None:
    """Copy running statistics from ``mask_rcnn_losses``' state into the
    model's buffers."""
    buffers = dict(model.named_buffers())
    with torch.no_grad():
        for name, value in state.items():
            buffers[name].copy_(value)


def make_train_step(model: MaskRCNN, optimizer: TrainOptimizer,
                    tc: Optional[TrainConfig] = None
                    ) -> Callable[[Dict[str, torch.Tensor]],
                                  Dict[str, torch.Tensor]]:
    """-> step(batch of device tensors) -> metrics (0-d tensors): loss,
    backward, one optimizer update, then the running statistics."""
    return _make_step(model, optimizer, tc, None)


def _make_step(model: MaskRCNN, optimizer: TrainOptimizer,
               tc: Optional[TrainConfig], group
               ) -> Callable[[Dict[str, torch.Tensor]],
                             Dict[str, torch.Tensor]]:
    """The train step; with ``group``, on this rank's chunk, the gradient
    and the metrics averaged over the group."""
    pixel_std = tc.pixel_std if tc is not None else "torchvision"

    def step(batch):
        image, masks = _prep_batch(batch, pixel_std)
        optimizer.zero_grad()
        total, (parts, state) = mask_rcnn_losses(
            model, image, batch["boxes"], masks, batch["valid"],
            return_state=True)
        total.backward()
        if group is not None:
            _average_gradients(optimizer.params, group)
        optimizer.step()
        load_batch_stats(model, state)
        metrics = {"total_loss": total.detach(),
                   **{k: v.detach() for k, v in parts.items()}}
        if group is not None:
            values = torch.stack(list(metrics.values()))
            dist.all_reduce(values, group=group)
            values.div_(dist.get_world_size(group))
            metrics = dict(zip(metrics, values.unbind()))
        return metrics

    return step


def _average_gradients(params: List[torch.nn.Parameter], group) -> None:
    """One all-reduce (SUM) of the flat gradient over ``group``, divided by
    its size.  It runs after ``backward()`` returns: the batch norms'
    collectives of the backward pass (remat's recomputation included) must
    have the group to themselves."""
    for p in params:            # every rank's buffer has the same layout
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    # back into the gradients' own memory layouts: the clip's sums of
    # squares run in memory order
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p))


def _rank_chunk(batch: Dict, rank: int, world: int) -> Dict:
    """Rank ``rank``'s chunk of each array (numpy or torch) of a global
    batch split into ``world`` equal chunks, in order."""
    b = len(next(iter(batch.values())))
    if b % world:
        raise ValueError(f"a batch of {b} does not split into {world} "
                         f"equal chunks")
    n = b // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def _broadcast_state(model: torch.nn.Module, group) -> None:
    """Rank 0's parameters and buffers to every rank of ``group``: one
    broadcast per dtype over a flat copy."""
    src = dist.get_global_rank(group, 0)
    tensors = list(model.state_dict().values())
    with torch.no_grad():
        for dtype in dict.fromkeys(t.dtype for t in tensors):
            same = [t for t in tensors if t.dtype == dtype]
            flat = torch.cat([t.reshape(-1) for t in same])
            dist.broadcast(flat, src=src, group=group)
            for t, v in zip(same, flat.split([t.numel() for t in same])):
                t.copy_(v.view_as(t))


def _make_chunk_step(model: MaskRCNN, optimizer: TrainOptimizer, group,
                     tc: Optional[TrainConfig] = None
                     ) -> Callable[[Dict[str, torch.Tensor]],
                                   Dict[str, torch.Tensor]]:
    """:func:`make_sharded_train_step`'s step on this rank's chunk."""
    set_sync_group(model, group)
    _broadcast_state(model, group)
    return _make_step(model, optimizer, tc, group)


def make_sharded_train_step(model: MaskRCNN, optimizer: TrainOptimizer,
                            mesh, tc: Optional[TrainConfig] = None
                            ) -> Callable[[Dict[str, torch.Tensor]],
                                          Dict[str, torch.Tensor]]:
    """-> step(global batch) -> metrics, over ``mesh``: a
    ``torch.distributed`` process group (``torch.distributed.group.WORLD``
    for the default one), one process per device, every process calling
    the step with the same global batch.

    Each rank takes its equal chunk, in order (a batch that does not split
    raises ``ValueError``), runs forward and backward on it with batch
    norm's statistics over the group, all-reduces the flat gradient of the
    trainable parameters once and divides it by the group's size, then
    makes :class:`TrainOptimizer`'s update and loads the running
    statistics.  The metrics are the loss parts averaged over the group.
    Building the step sets the group on every ``BatchNorm`` of ``model``
    and broadcasts rank 0's parameters and buffers to every rank."""
    step = _make_chunk_step(model, optimizer, mesh, tc)
    rank, world = dist.get_rank(mesh), dist.get_world_size(mesh)
    return lambda batch: step(_rank_chunk(batch, rank, world))


def step_loss_only(model: MaskRCNN, pixel_std: str = "torchvision"
                   ) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """-> f(batch) -> total loss, without gradients or statistics updates."""
    def f(batch):
        image, masks = _prep_batch(batch, pixel_std)
        with torch.no_grad():
            total, _ = mask_rcnn_losses(model, image, batch["boxes"], masks,
                                        batch["valid"])
        return total
    return f


def _evaluate(loss_fn, dataset, to_device, max_batches: int = 8,
              logger=None, group=None) -> Optional[float]:
    """Mean validation loss, or None when the dataset yields nothing (a
    one-shot generator exhausts after the first eval; inf there would count
    as a plateau and stop early).  With ``group`` each batch's loss is the
    mean of the ranks' losses on their chunks, all-reduced, so that every
    rank returns the same value."""
    vals = []
    for i, batch in enumerate(dataset):
        if i >= max_batches:
            break
        vals.append(loss_fn(to_device(batch)).detach().reshape(1))
    if vals and group is not None:
        vals = torch.cat(vals)
        dist.all_reduce(vals, group=group)
        vals = vals / dist.get_world_size(group)
    vals = [float(v) for v in vals]
    if not vals:
        if logger:
            logger.warning(
                "val_dataset yielded no batches (exhausted one-shot "
                "iterator?) - skipping this eval; pass a re-iterable")
        return None
    return float(np.mean(vals))


class _Prefetcher:
    """Host batches to the device: pinned memory and a non-blocking copy on
    a side stream, so that the next batch uploads while a step computes."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def put(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in batch.items()}
        if self.stream is None:
            return tensors
        with torch.cuda.stream(self.stream):
            return {k: t.pin_memory().to(self.device, non_blocking=True)
                    for k, t in tensors.items()}

    def get(self, staged: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.stream is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_stream(self.stream)
            for t in staged.values():
                t.record_stream(current)
        return staged


def _device(device, sharded: bool = False) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names a card that
    is not there.  In a sharded run ``"cuda"`` without an index is the
    process's own card, ``cuda:LOCAL_RANK``."""
    if sharded and str(device) == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK') or 0)}"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("train_model: CUDA is not available; pass "
                               "device='cpu' to train on the CPU")
        if device.index is not None and \
                device.index >= torch.cuda.device_count():
            raise RuntimeError(f"train_model: {device} is not a visible "
                               f"card ({torch.cuda.device_count()} visible)")
    return device


def save_checkpoint(path: str, model: torch.nn.Module) -> None:
    """Write the model's variables (params and, with batch norm, the
    running statistics, unfolded) as a float32 Flax-layout ``.npz`` at
    ``path``."""
    save_checkpoint_npz(path, to_flax_params(model.state_dict()),
                        dtype=np.float32)


def train_model(dataset: Iterable[Dict[str, np.ndarray]],
                val_dataset: Optional[Iterable] = None,
                model_cfg: Optional[MaskRCNNConfig] = None,
                train_cfg: Optional[TrainConfig] = None,
                init_params: Optional[Dict[str, torch.Tensor]] = None,
                mesh=None, logger=None,
                checkpoint_path: Optional[str] = None,
                device="cuda") -> Tuple[Dict[str, torch.Tensor],
                                        Dict[str, list]]:
    """Train with early stopping (the reference ``MyTrainer``'s patience,
    ``train_foundation_model.py:193-195``) -> (state dict, history).

    ``dataset`` yields dicts of numpy arrays: image (B, S, S, 3) uint8 RGB
    or normalized float32, boxes (B, G, 4), masks (B, G, S/4, S/4), valid
    (B, G).  ``init_params`` is a ``MaskRCNN`` state dict (e.g. from
    ``models.convert.load_checkpoint``); without it the model starts from
    :func:`create_model`.  With ``val_dataset`` the loss on it is taken
    every ``eval_period`` steps; the state dict returned is the one of the
    best evaluation (saved to ``checkpoint_path`` as it is reached), and
    ``patience`` evaluations without a better one stop the run.  Runs on
    ``device`` (default ``cuda``; raises when CUDA is missing).  ``history``
    holds ``total_loss`` per step, ``val_loss`` per evaluation and
    ``step_s``, each step's wall seconds (the read-back of its loss
    included).

    ``mesh``: a ``torch.distributed`` process group (one process per
    device; the caller initialises it, with the backend of its choice:
    gloo, or NCCL where each rank has a card of its own).  Every rank
    calls ``train_model`` with the same arguments and iterates the same
    batches; the step is :func:`make_sharded_train_step`'s, each rank
    uploads only its chunk of each batch, validation runs on the chunks
    with the losses all-reduced, so every rank returns the same state dict
    and history, and only rank 0 writes ``checkpoint_path``.  ``device=
    "cuda"`` without an index is then ``cuda:LOCAL_RANK``; an explicit
    index lets ranks share a card.
    """
    tc = train_cfg or TrainConfig.from_preset("update")
    mc = model_cfg or MaskRCNNConfig()
    dev = _device(device, sharded=mesh is not None)
    if init_params is None:
        model = create_model(mc)
    else:
        model = MaskRCNN(mc)
        model.load_state_dict(init_params, strict=True)
    model = model.to(dev).train()
    optimizer = make_optimizer(tc, model)
    prefetch = _Prefetcher(dev)
    if mesh is None:
        step_fn = make_train_step(model, optimizer, tc)
        rank = 0

        def host_chunk(batch):
            return batch
    else:
        step_fn = _make_chunk_step(model, optimizer, mesh, tc)
        rank, world = dist.get_rank(mesh), dist.get_world_size(mesh)

        def host_chunk(batch):
            return _rank_chunk(batch, rank, world)

    def to_device(batch):
        return prefetch.get(prefetch.put(host_chunk(batch)))

    loss_only = (step_loss_only(model, tc.pixel_std)
                 if val_dataset is not None else None)
    # step_s: wall seconds of each step, the loss read back included
    history: Dict[str, list] = {"total_loss": [], "val_loss": [],
                                "step_s": []}

    def snapshot():
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    best_val = float("inf")
    # as in the JAX loop: without an evaluation that improves, the initial
    # parameters are the best
    best_params = snapshot() if val_dataset is not None else None
    bad_evals = 0
    it = 0
    data_iter = iter(dataset)
    t0 = time.time()

    def next_host_batch():
        nonlocal data_iter
        try:
            return next(data_iter)
        except StopIteration:
            data_iter = iter(dataset)
            return next(data_iter)

    staged = prefetch.put(host_chunk(next_host_batch()))
    while it < tc.max_iter:
        t_step = time.perf_counter()
        batch = prefetch.get(staged)
        if it + 1 < tc.max_iter:
            staged = prefetch.put(host_chunk(next_host_batch()))
        metrics = step_fn(batch)
        it += 1
        history["total_loss"].append(float(metrics["total_loss"]))
        history["step_s"].append(time.perf_counter() - t_step)
        if logger and it % 20 == 0:
            logger.info(f"iter {it}/{tc.max_iter} loss "
                        f"{history['total_loss'][-1]:.4f} "
                        f"({(time.time() - t0) / it:.2f}s/it)")
        if val_dataset is not None and it % tc.eval_period == 0:
            val = _evaluate(loss_only, val_dataset, to_device,
                            tc.max_eval_batches, logger, group=mesh)
            if val is None:
                continue  # exhausted iterator: no signal, no early-stop tick
            history["val_loss"].append(val)
            if val < best_val:
                best_val = val
                best_params = snapshot()
                bad_evals = 0
                if checkpoint_path and rank == 0:
                    save_checkpoint(checkpoint_path, model)
            else:
                bad_evals += 1
                if bad_evals >= tc.patience:
                    if logger:
                        logger.info(f"Early stop at iter {it} "
                                    f"(patience {tc.patience})")
                    return best_params, history
    return (best_params if val_dataset is not None else snapshot()), history
