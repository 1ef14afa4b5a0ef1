"""The port's multi-device train step (``make_sharded_train_step``,
``train_model(mesh=...)``) on the CPU, two processes over gloo, at
``tests/test_train.py``'s TINY size.

What one device computes at the global batch is the reference: the two
ranks' step is held against the port's one-process ``make_train_step`` at
the same global batch of 2, and the port's sharded loop against the JAX
package's ``train_model`` over a 2-device CPU mesh.  The batch's two images
differ strongly (one dark, one bright), so batch-norm statistics kept per
chunk would give another model: the control test shows that the tolerances
below tell the two apart by more than 10x.

Tolerances (those of ``tests/test_torch_train_step.py``):
- losses within 1e-4 relative at each of 3 steps, the validation loss too;
- each tensor's update (after - before) within 3e-2 of its update's L2
  norm, plus 1e-6 of the tensor's and 1e-12 (float32 rounding of updates
  below a parameter's ulp, and of exact-0 updates behind a zero scale);
- running statistics within 1e-4 of the largest; frozen tensors
  bit-unchanged;
- stage by stage, the backbone alone in float64 (where rounding flips no
  ReLU): outputs and gradients within 1e-12 of each tensor's max-abs
  (the two formulas of the variance differ there by ~1e-14; statistics per
  chunk miss by ~1);
- the ranks' state dicts EQUAL bit for bit, and a group of one process
  EQUAL to ``make_train_step`` bit for bit.

Each spawned process (the ranks, and the JAX run) has its own timeout and
is killed when the test fails."""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_train_losses import (  # noqa: F401 (a fixture)
    KEYS, port_cfg, port_model, torch_threads)
from test_train import TINY, make_batch
from treedetection_tpu.models.mask_rcnn import create_model as jax_create_model

from treedetection_tpu_torch.models.convert import from_flax_params
from treedetection_tpu_torch.train import train as tt

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
STEPS = 3
SPAWN_TIMEOUT_S = 120
JAX_TIMEOUT_S = 300
LOSS_RTOL = 1e-4
UPDATE_RTOL = 3e-2
STATS_RTOL = 1e-4
STAGE64_RTOL = 1e-12
# norm -> (preset, backbone_freeze, remat) of the step comparison
JOBS = {"batch": ("scratch", 0, True), "frozen": ("update", 3, False)}
# the train_model comparison with JAX: batch norm, validation at the end
LOOP_TC = dict(max_iter=STEPS, eval_period=STEPS, backbone_freeze=0,
               ims_per_batch=WORLD, max_eval_batches=1)


def contrast_batch(seed: int) -> dict:
    """TINY's batch of 2 with one dark and one bright image."""
    batch = make_batch(b=WORLD, seed=seed)
    img = batch["image"]
    img[0] = img[0] * 0.5 - 1.5
    img[1] = img[1] * 0.5 + 1.5
    return batch


def job_config(norm: str):
    preset, freeze, remat = JOBS[norm]
    return (port_cfg(norm=norm, remat=remat),
            tt.TrainConfig.from_preset(preset, backbone_freeze=freeze))


def snapshot(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def one_process_run(model, tc, batch) -> tuple:
    """``STEPS`` one-process steps -> (losses, state dict after them)."""
    step = tt.make_train_step(model, tt.make_optimizer(tc, model), tc)
    tb = {k: torch.from_numpy(batch[k]) for k in KEYS}
    losses = [float(step(tb)["total_loss"]) for _ in range(STEPS)]
    return losses, snapshot(model)


def assert_state_close(before, ref, got, frozen=()):
    """``got`` against ``ref`` (both after the same steps from ``before``):
    updates in L2, running statistics by the largest, frozen tensors
    unchanged.  -> the number of tensors that moved."""
    moved = 0
    for k, r in ref.items():
        if k.endswith((".mean", ".var")):
            err = float((got[k] - r).abs().max())
            assert err <= STATS_RTOL * max(float(r.abs().max()), 1.0), (k, err)
            continue
        if k.startswith(frozen):
            assert torch.equal(got[k], before[k]), k
            assert torch.equal(r, before[k]), k
            continue
        ref_up, got_up = r - before[k], got[k] - before[k]
        err = float((got_up - ref_up).norm())
        assert err <= UPDATE_RTOL * float(ref_up.norm()) \
            + 1e-6 * float(r.norm()) + 1e-12, (k, err, float(ref_up.norm()))
        moved += bool(ref_up.abs().max() > 0)
    return moved


def stage64_backbone(params):
    cfg, _ = job_config("batch")
    return port_model(params, norm="batch", remat=cfg.remat).backbone.double()


def stage64_cotangents(params, batch):
    """Seeded float64 cotangents of the backbone's five outputs at the
    global batch."""
    rng = np.random.default_rng(5)
    with torch.no_grad():
        feats = stage64_backbone(params)(
            torch.from_numpy(batch["image"]).double())
    return [torch.from_numpy(rng.standard_normal(f.shape)) for f in feats]


def stage64_run(params, image, cots):
    """One process: the float64 backbone's outputs and parameter gradients
    under ``cots`` on ``image``."""
    backbone = stage64_backbone(params)
    feats = backbone(torch.from_numpy(image).double())
    sum((f * c).sum() for f, c in zip(feats, cots)).backward()
    return ([f.detach() for f in feats],
            {k: p.grad for k, p in backbone.named_parameters()
             if p.grad is not None})


def assert_equal_states(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# --- the spawned ranks and the JAX run ----------------------------------------

CHILD = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(2)
repo, root, rank, world = sys.argv[1:5]
rank, world = int(rank), int(world)
sys.path.insert(0, repo)
from treedetection_tpu_torch.models.mask_rcnn import MaskRCNN, MaskRCNNConfig
from treedetection_tpu_torch.train import train as tt
dist.init_process_group("gloo", init_method=f"file://{root}/rdzv",
                        rank=rank, world_size=world)
with open(os.path.join(root, "spec.json")) as fh:
    spec = json.load(fh)
init = torch.load(os.path.join(root, "init.pt"))
batches = {}
for name in ("batch", "val"):
    with np.load(os.path.join(root, name + ".npz")) as z:
        batches[name] = {k: z[k] for k in z.files}
tb = {k: torch.from_numpy(v) for k, v in batches["batch"].items()}
out = {"rank": dist.get_rank(), "losses": {}}
for norm, job in spec["jobs"].items():
    model = MaskRCNN(MaskRCNNConfig(**job["cfg"]))
    model.load_state_dict(init[norm])
    tc = tt.TrainConfig(**job["tc"])
    step = tt.make_sharded_train_step(model, tt.make_optimizer(tc, model),
                                      dist.group.WORLD, tc)
    out["losses"][norm] = [float(step(tb)["total_loss"])
                           for _ in range(spec["steps"])]
    torch.save(model.state_dict(), os.path.join(root, f"{norm}_{rank}.pt"))
# the backbone alone in float64, its outputs and parameter gradients under
# a seeded cotangent (summed over the global batch, so the ranks' gradients
# add up to one process's)
from treedetection_tpu_torch.models.resnet import set_sync_group
model = MaskRCNN(MaskRCNNConfig(**spec["jobs"]["batch"]["cfg"]))
model.load_state_dict(init["batch"])
backbone = model.backbone.double()
set_sync_group(backbone, dist.group.WORLD)
with np.load(os.path.join(root, "cotangents.npz")) as z:
    cots = [torch.from_numpy(z[f"p{i}"]) for i in range(len(z.files))]
n = tb["image"].shape[0] // world
part = slice(rank * n, (rank + 1) * n)
feats = backbone(tb["image"][part].double())
sum((f * c[part]).sum() for f, c in zip(feats, cots)).backward()
grads = {k: p.grad for k, p in backbone.named_parameters()
         if p.grad is not None}
for g in grads.values():
    dist.all_reduce(g)
torch.save({"feats": [f.detach() for f in feats], "grads": grads},
           os.path.join(root, f"stage64_{rank}.pt"))
try:                    # 3 images do not split over 2 ranks
    step({k: torch.cat([v, v[:1]]) for k, v in tb.items()})
    out["odd_batch"] = None
except ValueError as exc:
    out["odd_batch"] = str(exc)
loop = spec["loop"]
state, history = tt.train_model(
    [batches["batch"]], val_dataset=[batches["val"]],
    model_cfg=MaskRCNNConfig(**loop["cfg"]),
    train_cfg=tt.TrainConfig(**loop["tc"]), init_params=init["batch"],
    mesh=dist.group.WORLD,
    checkpoint_path=os.path.join(root, f"ckpt_{rank}.npz"), device="cpu")
torch.save(state, os.path.join(root, f"loop_{rank}.pt"))
out["history"] = {k: history[k] for k in ("total_loss", "val_loss")}
dist.destroy_process_group()
print("RESULT " + json.dumps(out), flush=True)
"""

JAX_CHILD = r"""
import pickle, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from jax.sharding import Mesh
repo, root = sys.argv[1:3]
sys.path.insert(0, repo)
from treedetection_tpu.models.mask_rcnn import MaskRCNNConfig
from treedetection_tpu.train import train as jt
with open(root + "/jax_in.pkl", "rb") as fh:
    spec = pickle.load(fh)
assert len(jax.devices()) == 2, jax.devices()
mesh = Mesh(np.array(jax.devices()), ("data",))
params, history = jt.train_model(
    [spec["batch"]], val_dataset=[spec["val"]],
    model_cfg=MaskRCNNConfig(**spec["cfg"]),
    train_cfg=jt.TrainConfig(**spec["tc"]), init_params=spec["params"],
    mesh=mesh)
with open(root + "/jax_out.pkl", "wb") as fh:
    pickle.dump({"params": jax.device_get(params), "history": history}, fh)
"""


def _wait(procs, timeout):
    """Wait for every (process, log) -> their logs' texts; fail the test on
    a non-zero exit or a timeout (the finally of the caller kills)."""
    texts = []
    for p, log in procs:
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pytest.fail(f"a child outlasted {timeout} s")
        log.close()
        text = Path(log.name).read_text()
        assert rc == 0, text[-3000:]
        texts.append(text)
    return texts


def _kill(procs):
    for p, log in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks of every job, the JAX 2-device loop beside them, and the
    one-process references computed meanwhile."""
    root = tmp_path_factory.mktemp("sharded")
    batch, val = contrast_batch(0), contrast_batch(1)
    jax_cfgs = {norm: dataclasses.replace(TINY, norm=norm) for norm in JOBS}
    params = {norm: jax.device_get(jax_create_model(cfg)[1])
              for norm, cfg in jax_cfgs.items()}
    init = {norm: from_flax_params(p) for norm, p in params.items()}
    torch.save(init, root / "init.pt")
    np.savez(root / "batch.npz", **batch)
    np.savez(root / "val.npz", **val)
    cots = stage64_cotangents(params["batch"], batch)
    np.savez(root / "cotangents.npz",
             **{f"p{i}": c.numpy() for i, c in enumerate(cots)})
    jobs = {}
    for norm in JOBS:
        cfg, tc = job_config(norm)
        jobs[norm] = {"cfg": dataclasses.asdict(cfg),
                      "tc": dataclasses.asdict(tc)}
    loop_cfg = port_cfg(norm="batch", remat=True)
    loop_tc = tt.TrainConfig.from_preset("scratch", **LOOP_TC)
    (root / "spec.json").write_text(json.dumps({
        "jobs": jobs, "steps": STEPS,
        "loop": {"cfg": dataclasses.asdict(loop_cfg),
                 "tc": dataclasses.asdict(loop_tc)}}))
    with open(root / "jax_in.pkl", "wb") as fh:
        pickle.dump({"batch": batch, "val": val, "params": params["batch"],
                     "cfg": dataclasses.asdict(jax_cfgs["batch"]),
                     "tc": dataclasses.asdict(loop_tc)}, fh)

    base = {k: v for k, v in os.environ.items()
            if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                         "MASTER_PORT")}
    jax_env = dict(base, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO),
                   XLA_FLAGS="--xla_force_host_platform_device_count=2")
    env = dict(base, OMP_NUM_THREADS="2", PYTHONPATH=str(REPO))
    jax_log = open(root / "jax.log", "w")
    jax_proc = [(subprocess.Popen(
        [sys.executable, "-c", JAX_CHILD, str(REPO), str(root)],
        cwd=str(root), env=jax_env, stdout=jax_log,
        stderr=subprocess.STDOUT), jax_log)]
    procs = []
    try:
        for rank in range(WORLD):
            log = open(root / f"rank_{rank}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-c", CHILD, str(REPO), str(root),
                 str(rank), str(WORLD)], cwd=str(root), env=env, stdout=log,
                stderr=subprocess.STDOUT), log))
        # the one-process references while the children run
        ref = {}
        for norm in JOBS:
            cfg, tc = job_config(norm)
            model = port_model(params[norm], norm=norm, remat=cfg.remat)
            ref[norm] = (snapshot(model),) + one_process_run(model, tc, batch)
        texts = _wait(procs, SPAWN_TIMEOUT_S)
        _wait(jax_proc, JAX_TIMEOUT_S)
    finally:
        _kill(procs + jax_proc)
    results = [json.loads(next(line[len("RESULT "):]
                               for line in text.splitlines()
                               if line.startswith("RESULT ")))
               for text in texts]
    with open(root / "jax_out.pkl", "rb") as fh:
        jax_out = pickle.load(fh)
    return {"root": root, "batch": batch, "params": params, "ref": ref,
            "results": results, "jax": jax_out, "init": init, "cots": cots}


def _rank_state(runs, name, rank):
    return torch.load(runs["root"] / f"{name}_{rank}.pt")


@pytest.mark.parametrize("norm", list(JOBS))
def test_two_ranks_match_one_process(runs, norm):
    """(a) Two ranks at a global batch of 2 against one process at batch
    2: the losses of every step, the updates and the running statistics
    after 3 steps; both ranks report the same losses."""
    before, ref_losses, ref_state = runs["ref"][norm]
    for r in runs["results"]:
        got = r["losses"][norm]
        assert got == pytest.approx(ref_losses, rel=LOSS_RTOL), (got,
                                                                 ref_losses)
    _, tc = job_config(norm)
    frozen = tuple(tt._frozen_prefixes(tc.backbone_freeze))
    moved = assert_state_close(before, ref_state,
                               _rank_state(runs, norm, 0), frozen)
    assert moved > 0
    if norm == "batch":      # the statistics moved, over the global batch
        k = "backbone.bottom_up.stem.norm.mean"
        assert not torch.equal(ref_state[k], before[k])


@pytest.mark.parametrize("name", list(JOBS) + ["loop"])
def test_ranks_stay_bit_equal(runs, name):
    """Every rank's parameters and buffers EQUAL after the steps (the same
    reduced bits, the same update on every rank), and the losses too."""
    assert_equal_states(_rank_state(runs, name, 0),
                        _rank_state(runs, name, 1))
    a, b = runs["results"]
    if name == "loop":
        assert a["history"] == b["history"]
    else:
        assert a["losses"][name] == b["losses"][name]


def test_backbone_float64_matches_one_process(runs):
    """The synced batch norm stage by stage: the backbone (remat on) in
    float64, where rounding flips no ReLU, on each rank's chunk with a
    seeded cotangent: the outputs of both ranks side by side, and the
    gradients summed over the ranks, within 1e-12 of each tensor's max-abs
    of one process's at the global batch.  Statistics per chunk (each half
    alone) miss the outputs by more than 10x that."""
    params, batch, cots = runs["params"]["batch"], runs["batch"], runs["cots"]
    ref_feats, ref_grads = stage64_run(params, batch["image"], cots)
    got = [torch.load(runs["root"] / f"stage64_{r}.pt") for r in range(WORLD)]

    def rel(a, b):      # an exact 0 (behind a zero scale) must stay 0
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)

    for i, ref in enumerate(ref_feats):
        out = torch.cat([g["feats"][i] for g in got])
        assert rel(out, ref) <= STAGE64_RTOL, (i, rel(out, ref))
    assert got[0]["grads"].keys() == ref_grads.keys()
    for k, ref in ref_grads.items():
        assert torch.equal(got[0]["grads"][k], got[1]["grads"][k]), k
        assert rel(got[0]["grads"][k], ref) <= STAGE64_RTOL, (
            k, rel(got[0]["grads"][k], ref))
    halves = [stage64_run(params, batch["image"][i:i + 1],
                          [c[i:i + 1] for c in cots])[0]
              for i in range(WORLD)]
    miss = max(rel(torch.cat([h[i] for h in halves]), ref)
               for i, ref in enumerate(ref_feats))
    assert miss > 10 * STAGE64_RTOL, miss


def test_per_chunk_statistics_miss(runs):
    """(b) The comparison can fail: each half of the batch alone through
    ``make_train_step`` (batch-norm statistics per chunk, as data
    parallelism with a plain batch norm would take them) misses the
    global step's loss by more than 10x the loss tolerance, while the
    two ranks meet it."""
    norm = "batch"
    _, ref_losses, _ = runs["ref"][norm]
    cfg, tc = job_config(norm)
    halves = []
    for i in range(WORLD):
        half = {k: v[i:i + 1] for k, v in runs["batch"].items()}
        model = port_model(runs["params"][norm], norm=norm, remat=cfg.remat)
        halves.append(one_process_run(model, tc, half)[0])
    per_chunk = np.mean(halves, axis=0)
    miss = abs(per_chunk[0] - ref_losses[0]) / abs(ref_losses[0])
    assert miss > 10 * LOSS_RTOL, (per_chunk, ref_losses)
    got = runs["results"][0]["losses"][norm]
    assert abs(got[0] - ref_losses[0]) <= LOSS_RTOL * abs(ref_losses[0])


def test_sharded_loop_matches_jax_mesh(runs):
    """(c) ``train_model(mesh=group)`` on two ranks against the JAX
    package's ``train_model(mesh=Mesh(2 CPU devices))`` from the same
    weights (``from_flax_params``) on the same batches: 3 steps and one
    validation, the loss histories within 1e-4 relative, the returned
    parameters within the update tolerance of JAX's."""
    ref = runs["jax"]["history"]
    for r in runs["results"]:
        got = r["history"]
        assert len(got["total_loss"]) == len(ref["total_loss"]) == STEPS
        assert len(got["val_loss"]) == len(ref["val_loss"]) == 1
        for key in ("total_loss", "val_loss"):
            assert got[key] == pytest.approx(ref[key], rel=LOSS_RTOL), key
    moved = assert_state_close(runs["init"]["batch"],
                               from_flax_params(runs["jax"]["params"]),
                               _rank_state(runs, "loop", 0))
    assert moved > 0


def test_only_rank_0_writes_the_checkpoint(runs):
    """(f) Both ranks were given a checkpoint path; only rank 0 wrote, and
    what it wrote is the state dict the loop returned."""
    root = runs["root"]
    assert (root / "ckpt_0.npz").is_file()
    assert not (root / "ckpt_1.npz").exists()
    from treedetection_tpu_torch.models.convert import load_checkpoint
    saved = load_checkpoint(str(root / "ckpt_0.npz"), depth=50)
    assert_equal_states(saved, _rank_state(runs, "loop", 0))


def test_odd_batch_raises_on_every_rank(runs):
    """(e) A batch of 3 over 2 ranks raises ValueError before any
    collective, on every rank."""
    for r in runs["results"]:
        assert r["odd_batch"] == "a batch of 3 does not split into 2 equal " \
                                 "chunks"


@pytest.mark.parametrize("rank", range(WORLD))
def test_rank_chunk_splits_in_order(rank):
    batch = {"a": np.arange(6), "b": torch.arange(12).reshape(6, 2)}
    got = tt._rank_chunk(batch, rank, WORLD)
    np.testing.assert_array_equal(got["a"], np.arange(6)[rank * 3:
                                                         (rank + 1) * 3])
    assert torch.equal(got["b"], batch["b"][rank * 3:(rank + 1) * 3])
    with pytest.raises(ValueError, match="does not split"):
        tt._rank_chunk({"a": np.arange(5)}, rank, WORLD)


@pytest.fixture()
def deterministic():
    """torch's deterministic algorithms: on the CPU the step itself gives
    other bits from run to run at 2 threads without them."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


@pytest.mark.parametrize("norm", list(JOBS))
def test_group_of_one_equals_one_process(runs, norm, tmp_path,
                                         deterministic):
    """(d) In this process, a group of one: ``make_sharded_train_step``
    EQUALS ``make_train_step`` bit for bit (losses and state dict)."""
    cfg, tc = job_config(norm)
    model = port_model(runs["params"][norm], norm=norm, remat=cfg.remat)
    ref_losses, ref_state = one_process_run(model, tc, runs["batch"])
    model = port_model(runs["params"][norm], norm=norm, remat=cfg.remat)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        step = tt.make_sharded_train_step(
            model, tt.make_optimizer(tc, model), dist.group.WORLD, tc)
        tb = {k: torch.from_numpy(runs["batch"][k]) for k in KEYS}
        losses = [float(step(tb)["total_loss"]) for _ in range(STEPS)]
    finally:
        dist.destroy_process_group()
    assert losses == ref_losses
    assert_equal_states(snapshot(model), ref_state)


@pytest.mark.parametrize("local_rank", [0, 1])
def test_sharded_cuda_is_the_local_rank_card(monkeypatch, local_rank):
    """In a sharded run ``device="cuda"`` is ``cuda:LOCAL_RANK``, and a
    rank whose card is not there raises (here: one visible card): no CPU
    fallback, no other card."""
    monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    if local_rank == 0:
        assert tt._device("cuda", sharded=True) == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="cuda:1 is not a visible"):
            tt._device("cuda", sharded=True)
    # an explicit index is the caller's choice: ranks may share a card
    assert tt._device("cuda:0", sharded=True) == torch.device("cuda", 0)
    assert tt._device("cpu", sharded=True) == torch.device("cpu")
