"""The contrastive-extras slice's optimizer options against the JAX
package's (optax) on the CPU: AdamW, SGD and Lion with
``state_dtype=bfloat16`` against ``cast_opt_state`` of the same optax chain
over five clipped updates (parameters at 1e-6 as in the f32 tests, the
moments stored as bf16 tensors within one bf16 rounding of optax's);
``update_freq=3`` (``accum=multistep``) against ``optax.MultiSteps`` with
clipping, the parameters and the schedule's count after every call; and
a resume in the middle of an accumulation and of bf16 moments, bit for
bit against an unbroken run; the classification step's EMA under
``update_freq`` against the JAX step's."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avion_tpu.core.config import OptimConfig as JaxOptimConfig
from avion_tpu.core.train_state import TrainState as JaxTrainState
from avion_tpu.optim.factory import build_optimizer as jax_build_optimizer
from avion_tpu.train import steps as jax_steps
from avion_tpu_torch.core.config import OptimConfig
from avion_tpu_torch.core.train_state import TrainState
from avion_tpu_torch.models.pt_import import params_from_jax
from avion_tpu_torch.optim.factory import (Optimizer, build_optimizer,
                                           build_schedule, build_wd_schedule)
from avion_tpu_torch.train.steps import make_cls_train_step
from test_torch_finetune_optim import (CASES, COMMON, LAYERS, NITER, _grads,
                                       _init, _leaf, _tree)
from test_torch_videomae_model import finetune_pair
from test_torch_videomae_train import OPT as VMAE_OPT
from test_torch_videomae_train import TOL as VMAE_TOL
from test_torch_videomae_train import (_assert_params, _uint8_video,
                                       f32_prep)  # noqa: F401

BF16 = {"adamw": dict(optimizer="adamw", lr=1e-2, lr_end=1e-4, wd=0.05),
        "sgd": CASES["sgd"], "lion": CASES["lion"]}
# optax's name of each port moment
MOMENTS = {"exp_avg": "mu", "exp_avg_sq": "nu", "momentum_buffer": "trace"}
BF16_ULP = 2.0 ** -7  # bf16 keeps 8 significant bits: one rounding apart


def _port(init, cfg):
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    return params, Optimizer(params.items(), cfg, build_schedule(cfg, NITER),
                             LAYERS, build_wd_schedule(cfg, NITER))


def _call(params, opt, grads):
    for k, p in params.items():
        p.grad = torch.from_numpy(grads[k].copy())
    opt.update(opt.global_norm())


def _jax(init, **kw):
    tx, _ = jax_build_optimizer(JaxOptimConfig(**COMMON, **kw), _tree(init),
                                NITER, num_layers=LAYERS)
    params = _tree(init)
    return tx, params, tx.init(params)


@pytest.mark.parametrize("name", list(BF16))
def test_bf16_state_matches_cast_opt_state(name):
    init = _init()
    kw = dict(BF16[name], state_dtype="bfloat16")
    params, opt = _port(init, OptimConfig(**COMMON, **kw))
    tx, j_params, j_state = _jax(init, **kw)
    for g in _grads(init):
        _call(params, opt, g)
        updates, j_state = tx.update(_tree(g), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       _leaf(j_params, k), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{name} {k}")
    assert opt.count == 5
    names = {k: p for k, p in params.items()}
    for moment, j_name in MOMENTS.items():
        j_tree = optax.tree_utils.tree_get(j_state, j_name)
        for k, p in names.items():
            if moment not in opt.inner.state[p]:
                continue
            got = opt.inner.state[p][moment]
            assert got.dtype == torch.bfloat16, (k, moment)
            want = _leaf(j_tree, k)
            assert str(want.dtype) == "bfloat16", (k, moment)
            np.testing.assert_allclose(
                got.float().numpy(), want.astype(np.float32),
                rtol=BF16_ULP, atol=1e-30, err_msg=f"{name} {k} {moment}")


def test_multistep_matches_optax_multisteps():
    """Seven calls of ``update_freq=3`` with clipping: the core, the clip and
    the schedule act on the 3rd and the 6th, on the mean gradient; the
    parameters after every call and the schedule's count follow optax."""
    init = _init()
    kw = dict(BF16["adamw"], update_freq=3)
    params, opt = _port(init, OptimConfig(**COMMON, **kw))
    tx, j_params, j_state = _jax(init, **kw)
    grads = _grads(init) + _grads(init, n=2, seed=2)
    for i, g in enumerate(grads):
        _call(params, opt, g)
        updates, j_state = tx.update(_tree(g), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       _leaf(j_params, k), rtol=1e-6,
                                       atol=1e-6, err_msg=f"call {i} {k}")
        assert opt.count == int(j_state.gradient_step) == (i + 1) // 3
        assert opt.mini_step == int(j_state.mini_step)


def _resume(cfg, init, grads, at):
    """The parameters after ``grads`` in one run, and in a run whose
    optimizer state goes through ``torch.save`` / ``torch.load`` after
    ``at`` calls into a new optimizer over parameters restored to the same
    values."""
    params, opt = _port(init, cfg)
    for g in grads:
        _call(params, opt, g)
    whole = {k: p.detach().clone() for k, p in params.items()}
    params, opt = _port(init, cfg)
    for g in grads[:at]:
        _call(params, opt, g)
    buf = io.BytesIO()
    torch.save(opt.state_dict(), buf)
    buf.seek(0)
    params2, opt2 = _port({k: p.detach().numpy() for k, p in params.items()},
                          cfg)
    opt2.load_state_dict(torch.load(buf, weights_only=True))
    for g in grads[at:]:
        _call(params2, opt2, g)
    return whole, params2, opt2


@pytest.mark.parametrize("kw", [dict(update_freq=3),
                                dict(update_freq=3, state_dtype="bfloat16")],
                         ids=["f32", "bf16"])
def test_resume_inside_an_accumulation_is_exact(kw):
    """A resume after call 2 of 3 carries the running mean and the call
    count (and the bf16 moments, which stay bf16): five calls give the
    unbroken run's parameters bit for bit."""
    init = _init()
    cfg = OptimConfig(**COMMON, **BF16["adamw"], **kw)
    whole, params, opt = _resume(cfg, init, _grads(init), at=2)
    assert opt.count == 1 and opt.mini_step == 2
    for k, p in params.items():
        assert torch.equal(p.detach(), whole[k]), k
    dtypes = {s["exp_avg"].dtype for s in opt.inner.state.values()}
    assert dtypes == {torch.bfloat16 if kw.get("state_dtype")
                      else torch.float32}


def test_cls_ema_follows_every_call_under_update_freq(f32_prep):
    """The classification step with ``update_freq=2`` and an EMA, three
    calls against the JAX step over ``optax.MultiSteps``: the EMA averages
    after every call, the one that only accumulates too (the parameters
    then stand still), as the JAX step does."""
    jm, params, pm = finetune_pair(drop_path_rate=0.0)
    opt_kw = dict(VMAE_OPT, update_freq=2)
    tx, _ = jax_build_optimizer(JaxOptimConfig(**opt_kw), params, 4,
                                num_layers=2)
    jstep = jax.jit(jax_steps.make_cls_train_step(jm, tx, ema_decay=0.9))
    jstate = JaxTrainState.create(params, tx, use_ema=True)
    opt, _ = build_optimizer(OptimConfig(**opt_kw), pm, 4, num_layers=2)
    state = TrainState.create(pm, opt, use_ema=True)
    step = make_cls_train_step(pm, ema_decay=0.9)
    for i in range(3):
        batch = {"video": _uint8_video(7 + i),
                 "label": np.array([0, 3, 1, 4], np.int32)}
        jstate, _ = jstep(jstate, {k: jnp.asarray(v)
                                   for k, v in batch.items()},
                          jax.random.PRNGKey(0))
        state, _ = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        assert opt.count == (i + 1) // 2
        _assert_params(pm, jstate.params, **VMAE_TOL)
        want = params_from_jax(jax.device_get(jstate.ema_params))
        for k, v in want.items():
            np.testing.assert_allclose(state.ema[k].numpy(), v.numpy(),
                                       err_msg=f"call {i} {k}", **VMAE_TOL)
