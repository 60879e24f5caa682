"""Cached gradient accumulation of the port (``make_clip_accum_train_step``)
on the CPU, f32, against the JAX package's step and against the port's own
one-shot step on the same batch: ``loss_type`` clip and siglip, M = 2 and
4 microbatches, with the bounds of ``tests/test_grad_accum.py`` (loss to
1e-5, ``grad_norm`` to 1e-4, parameters after one step to 2e-4 / 2e-6);
SGD, whose update is linear in the gradient.  With patch dropout on, the
accumulated gradient equals that of one graph over the same microbatch
draws, which holds only when pass 2's live rows reproduce pass 1's cached
ones."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avion_tpu.core.config import OptimConfig as JaxOptimConfig
from avion_tpu.core.train_state import TrainState as JaxTrainState
from avion_tpu.models.clip import CLIP as JaxCLIP
from avion_tpu.optim.factory import build_optimizer as jax_build_optimizer
from avion_tpu.train.steps import \
    make_clip_accum_train_step as jax_make_accum
from avion_tpu_torch.core.config import OptimConfig
from avion_tpu_torch.core.train_state import TrainState
from avion_tpu_torch.losses.losses import clip_loss, siglip_loss
from avion_tpu_torch.models.clip import CLIP
from avion_tpu_torch.models.pt_import import params_from_jax
from avion_tpu_torch.optim.factory import build_optimizer
from avion_tpu_torch.train.loop import microbatch_major
from avion_tpu_torch.train.steps import (make_clip_accum_train_step,
                                         make_clip_train_step, step_seed)

TINY = dict(embed_dim=16, image_size=32, patch_size=16, num_frames=2,
            vision_width=32, vision_layers=1, vision_heads=2,
            context_length=8, vocab_size=64, text_width=16, text_heads=2,
            text_layers=1)
OPT = dict(optimizer="sgd", lr=1e-2, warmup_epochs=0, epochs=1,
           grad_clip_norm=1.0)
NITER = 100
BATCH = 32


def _kw(loss_type):
    return dict(use_logit_bias=loss_type == "siglip",
                temperature_init=0.1 if loss_type == "siglip" else 0.07)


def _host(seed=0):
    rs = np.random.RandomState(seed)
    return {"video": rs.rand(BATCH, 2, 32, 32, 3).astype(np.float32),
            "text": rs.randint(1, 64, (BATCH, 8)).astype(np.int32)}


def _jax_params(loss_type):
    jm = JaxCLIP(**TINY, use_flash=False, dtype=jnp.float32,
                 **_kw(loss_type))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((4, 2, 32, 32, 3)),
                              jnp.zeros((4, 8), jnp.int32))["params"]
    return jm, jax.tree_util.tree_map(np.asarray, params)


def _port(params, loss_type, **model_kw):
    model = CLIP(**TINY, dtype=torch.float32, **_kw(loss_type), **model_kw)
    model.load_state_dict(params_from_jax(params), strict=True)
    opt, _ = build_optimizer(OptimConfig(**OPT), model, NITER)
    return TrainState.create(model, opt)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("loss_type", ["clip", "siglip"])
@pytest.mark.parametrize("m", [2, 4])
def test_cached_accum_matches_jax_and_the_one_shot_step(loss_type, m):
    jm, params = _jax_params(loss_type)
    host = _host()
    tx, _ = jax_build_optimizer(JaxOptimConfig(**OPT), params, NITER)
    jstate = JaxTrainState.create(
        jax.tree_util.tree_map(jnp.asarray, params), tx)
    jstep = jax.jit(jax_make_accum(jm, tx, update_freq=m,
                                   loss_type=loss_type))
    micro = {k: v.reshape(m, BATCH // m, *v.shape[1:])
             for k, v in host.items()}
    jstate, jmetrics = jstep(jstate, micro, jax.random.PRNGKey(7))
    jparams = params_from_jax(jax.device_get(jstate.params))

    accum = _port(params, loss_type)
    accum, metrics = make_clip_accum_train_step(
        accum.model, m, loss_type=loss_type)(
            accum, microbatch_major(_torch(host), m))
    one = _port(params, loss_type)
    one, ref = make_clip_train_step(one.model, loss_type=loss_type)(
        one, _torch(host))
    assert metrics["step_ok"] == ref["step_ok"] == 1.0
    assert accum.step == 1 and accum.optimizer.count == 1
    for want, params_want in ((jmetrics, jparams),
                              (ref, one.model.state_dict())):
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(want["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(metrics["clip_acc"]),
                                   float(want["clip_acc"]))
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(want["grad_norm"]), rtol=1e-4)
        for k, v in accum.model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), np.asarray(params_want[k]),
                                       rtol=2e-4, atol=2e-6, err_msg=k)


@pytest.mark.parametrize("loss_type", ["clip", "siglip"])
def test_live_rows_reproduce_the_cached_ones_under_patch_dropout(loss_type):
    """Patch dropout at 0.5, no clip: the step's accumulated gradient and
    loss equal one graph's over the four microbatches, each drawing from
    (seed, step * M + m) as the step does."""
    m, seed = 4, 5
    _, params = _jax_params(loss_type)
    host = _torch(_host(1))
    cfg = OptimConfig(**dict(OPT, grad_clip_norm=None))
    states = []
    for _ in range(2):
        model = CLIP(**TINY, dtype=torch.float32, patch_dropout=0.5,
                     **_kw(loss_type))
        model.load_state_dict(params_from_jax(params), strict=True)
        states.append(TrainState.create(model, build_optimizer(
            cfg, model, NITER)[0]))
    state, ref_state = states
    state.step = ref_state.step = 3
    state, metrics = make_clip_accum_train_step(
        state.model, m, seed=seed, loss_type=loss_type)(
            state, microbatch_major(host, m))

    model = ref_state.model
    outs = []
    for i, mb in enumerate(zip(host["video"].chunk(m),
                               host["text"].chunk(m))):
        gen = torch.Generator().manual_seed(step_seed(seed, 3 * m + i))
        outs.append(model(mb[0], mb[1].long(), deterministic=False,
                          generator=gen))
    zi = torch.cat([o["image_embed"] for o in outs])
    zt = torch.cat([o["text_embed"] for o in outs])
    if loss_type == "siglip":
        ref = siglip_loss(zi, zt, outs[0]["logit_scale"],
                          outs[0]["logit_bias"])
    else:
        ref = clip_loss(zi, zt, outs[0]["logit_scale"])
    ref["loss"].backward()
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss"].item(),
                               rtol=1e-6)
    for (name, p), q in zip(state.model.named_parameters(),
                            model.parameters()):
        np.testing.assert_allclose(p.grad.numpy(), q.grad.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
