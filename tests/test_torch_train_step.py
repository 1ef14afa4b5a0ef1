"""The port's presets, learning-rate schedule, freezing, optimizer and train
step against the JAX package's (``treedetection_tpu/train/train.py``) on
the CPU, at ``tests/test_train.py``'s TINY size.

Tolerances:
- presets, configs and frozen sets identical;
- the learning rate of every step within 2e-6 relative of optax's, read
  from JAX's own optimizer (momentum and decay off, so an update is -lr*g):
  optax computes it in float32, where the warmup's ``(init - base) * frac
  + base`` cancels to a tenth of its terms, and XLA's fused arithmetic
  rounds that a few ulps otherwise than numpy's;
- the optimizer on the same gradients: parameters after 1 and 3 updates
  within 1e-6 of each tensor's max-abs (clip, decay, momentum, schedule);
- the whole train step: losses within 1e-4 relative at each of 3 steps;
  each tensor's update (after - before) within 3e-2 of its update's L2 norm
  (plus 1e-6 of the tensor's, a few float32 ulps, and 1e-12 for updates
  that are rounding noise of an exact 0), since the gradients themselves
  agree only to the ReLU-flip floor that ``tests/test_torch_train_grads.py``
  describes (the worst measured: 1.2%, res4's conv3 norm scales under batch
  norm after 3 steps; 0.23% with frozen norm); running statistics within
  1e-4 of the largest (after 3 steps they are statistics of parameters
  that differ by that floor); frozen tensors bit-unchanged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_losses import (  # noqa: F401 (a fixture)
    KEYS, port_model, torch_threads)
from test_train import TINY, make_batch
from treedetection_tpu.models.mask_rcnn import create_model as jax_create_model
from treedetection_tpu.train import train as jt

from treedetection_tpu_torch.models.convert import from_flax_params
from treedetection_tpu_torch.train import train as tt


def _flat(sd):
    return {k: v.detach().clone() for k, v in sd.items()}


def test_presets_and_config_match_jax():
    assert tt.PRESETS == jt.PRESETS
    for name in ("update", "scratch"):
        assert dataclasses.asdict(tt.TrainConfig.from_preset(name)) == \
            dataclasses.asdict(jt.TrainConfig.from_preset(name))
    over = {"max_iter": 7, "backbone_freeze": 0, "pixel_std": "ones"}
    assert dataclasses.asdict(tt.TrainConfig.from_preset("scratch", **over)) \
        == dataclasses.asdict(jt.TrainConfig.from_preset("scratch", **over))


@pytest.mark.parametrize("max_iter,warmup,base_lr", [
    (2000, 100, 0.005), (400, 100, 0.01), (50, 100, 0.02), (30, 0, 0.01)])
def test_lr_schedule_matches_optax(max_iter, warmup, base_lr):
    """Every step's learning rate, as JAX's optimizer applies it; among
    them steps 0, 1, warmup-1, warmup, 0.7*max and 0.9*max, where
    ``join_schedules`` hands the decay ``step - warmup``."""
    kw = dict(max_iter=max_iter, warmup_iters=warmup, base_lr=base_lr,
              momentum=0.0, weight_decay=0.0, clip_grad_norm=1e9,
              backbone_freeze=0)
    jtc, ttc = jt.TrainConfig(**kw), tt.TrainConfig(**kw)
    params = {"params": {"head": {"w": jnp.ones((1,), jnp.float32)}}}
    opt = jt.make_optimizer(jtc, params)
    grads = {"params": {"head": {"w": jnp.ones((1,), jnp.float32)}}}
    update = jax.jit(opt.update)
    state = opt.init(params)
    steps = max_iter + 3
    jax_lr = []
    for _ in range(steps):
        up, state = update(grads, state, params)
        jax_lr.append(-float(up["params"]["head"]["w"][0]))
    port = tt.lr_schedule(ttc)
    np.testing.assert_allclose([port(t) for t in range(steps)], jax_lr,
                               rtol=2e-6)
    # and the port's optimizer applies the same rate at each update
    w = torch.nn.Parameter(torch.zeros(1, dtype=torch.float64))
    topt = tt.TrainOptimizer(ttc, [w])
    applied = []
    for _ in range(steps):
        before = float(w)
        w.grad = torch.ones_like(w)
        topt.step()
        applied.append(before - float(w))
    np.testing.assert_allclose(applied, jax_lr, rtol=2e-6)


@pytest.fixture(scope="module")
def jax_params():
    return {norm: jax_create_model(dataclasses.replace(TINY, norm=norm))
            for norm in ("frozen", "batch")}


@pytest.mark.parametrize("n_stages", [0, 1, 2, 3, 4])
def test_frozen_sets_match_jax(jax_params, n_stages):
    """detectron2's FREEZE_AT: JAX's frozen labels, carried to parameter
    names, equal the parameters the port freezes (batch-norm running
    statistics are buffers in the port and labelled frozen in JAX)."""
    for norm, (_, params) in jax_params.items():
        labels = jt._freeze_mask(params, n_stages)
        marks = jax.tree.map(
            lambda lab, p: np.full(np.shape(p), lab == "frozen", np.float32),
            labels, jax.device_get(params))
        ref = {k for k, v in from_flax_params(marks).items()
               if bool(v.all()) and not k.endswith((".mean", ".var"))}
        assert all(bool(v.all()) for k, v in from_flax_params(marks).items()
                   if k.endswith((".mean", ".var")))
        model = port_model(params, norm=norm)
        got = tt._freeze_mask(model, n_stages)
        assert got == ref, (norm, n_stages, got ^ ref)
        assert got == {n for n, p in model.named_parameters()
                       if not p.requires_grad}
        assert (len(got) > 0) == (n_stages > 0)


def _random_grads(params, seed, scale):
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        if path[0].key == "batch_stats":
            return jnp.zeros_like(p)
        return jnp.asarray(rng.standard_normal(np.shape(p)).astype(
            np.float32) * scale)
    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.mark.parametrize("preset,norm,freeze", [
    ("update", "frozen", 3), ("scratch", "batch", 0)])
def test_optimizer_on_shared_gradients_matches_optax(jax_params, preset,
                                                     norm, freeze):
    """The same gradients through both optimizers for 3 updates (clipped at
    the first and third, the second under the clip norm)."""
    _, params = jax_params[norm]
    jtc = jt.TrainConfig.from_preset(preset, backbone_freeze=freeze,
                                     warmup_iters=2)
    opt = jt.make_optimizer(jtc, params)
    state = opt.init(params)
    model = port_model(params, norm=norm)
    topt = tt.make_optimizer(tt.TrainConfig(**dataclasses.asdict(jtc)), model)
    named = dict(model.named_parameters())
    jp = params
    for step, scale in enumerate((1e-2, 1e-6, 3e-3)):
        g = _random_grads(params, step, scale)
        up, state = jax.jit(opt.update)(g, state, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, up)
        gsd = from_flax_params({"params": jax.device_get(g)["params"]})
        for n, p in named.items():
            p.grad = gsd[n].clone() if p.requires_grad else None
        topt.step()
        if step in (0, 2):
            ref = from_flax_params(jax.device_get(jp))
            got = model.state_dict()
            for k, v in ref.items():
                err = float((got[k] - v).abs().max())
                assert err <= 1e-6 * max(float(v.abs().max()), 1e-30), (
                    step, k, err)


@pytest.fixture(scope="module")
def step_runs(jax_params):
    """(preset, norm) -> per step [(JAX params, JAX loss, port state dict,
    port loss)] over 3 steps of each package's train step on one batch."""
    batch = make_batch()
    out = {}
    for preset, norm in (("update", "frozen"), ("scratch", "batch")):
        jmodel, params = jax_params[norm]
        jtc = jt.TrainConfig.from_preset(preset)
        opt = jt.make_optimizer(jtc, params)
        jstep = jax.jit(jt.make_train_step(jmodel, opt, jtc))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        state = opt.init(params)
        model = port_model(params, norm=norm)
        tstep = tt.make_train_step(
            model, tt.make_optimizer(tt.TrainConfig.from_preset(preset),
                                     model))
        tb = {k: torch.from_numpy(batch[k]) for k in KEYS}
        runs = [(jax.device_get(params), None, _flat(model.state_dict()),
                 None)]
        jp = params
        for _ in range(3):
            jp, state, jm = jstep(jp, state, jb, jax.random.PRNGKey(0))
            tm = tstep(tb)
            runs.append((jax.device_get(jp), float(jm["total_loss"]),
                         _flat(model.state_dict()), float(tm["total_loss"])))
        out[(preset, norm)] = runs
    return out


@pytest.mark.parametrize("preset,norm", [("update", "frozen"),
                                         ("scratch", "batch")])
@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_matches_jax(step_runs, preset, norm, steps):
    runs = step_runs[(preset, norm)]
    for _, jloss, _, tloss in runs[1:steps + 1]:
        assert tloss == pytest.approx(jloss, rel=1e-4)
    jp0 = from_flax_params(runs[0][0])
    jpn = from_flax_params(runs[steps][0])
    t0, tn = runs[0][2], runs[steps][2]
    frozen = tuple(tt._frozen_prefixes(
        tt.TrainConfig.from_preset(preset).backbone_freeze))
    moved = 0
    for k, ref in jpn.items():
        if k.endswith((".mean", ".var")):       # running statistics
            err = float((tn[k] - ref).abs().max())
            assert err <= 1e-4 * max(float(ref.abs().max()), 1.0), (k, err)
            continue
        if k.startswith(frozen):
            assert torch.equal(tn[k], t0[k]) and torch.equal(ref, jp0[k]), k
            continue
        ref_up, got_up = ref - jp0[k], tn[k] - t0[k]
        err = float((got_up - ref_up).norm())
        # + 1e-6 of the tensor's norm: an update below a float32 ulp of its
        # parameter rounds away in one package and not in the other; + 1e-12:
        # behind a batch-norm scale that starts at 0 the exact gradient is 0
        # and both packages update by rounding noise
        assert err <= 3e-2 * float(ref_up.norm()) \
            + 1e-6 * float(ref.norm()) + 1e-12, (k, err)
        moved += bool(ref_up.abs().max() > 0)
    assert moved > 0
    if norm == "batch":      # the frozen stem's statistics still move
        assert not torch.equal(tn["backbone.bottom_up.stem.norm.mean"],
                               t0["backbone.bottom_up.stem.norm.mean"])


def test_loss_falls_over_three_steps(step_runs):
    """The same batch three times: the loss must drop (the JAX package's
    ``test_loss_decreases_on_steps``, on the port)."""
    losses = [r[3] for r in step_runs[("update", "frozen")][1:]]
    assert losses[-1] < losses[0]


def test_train_model_needs_cuda_by_default():
    """No silent move to the CPU: without a card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.train_model([make_batch()], train_cfg=tt.TrainConfig(max_iter=1))
