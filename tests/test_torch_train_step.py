"""One CLIP train step of the port against the JAX package's
``make_clip_train_step`` on the CPU: the tiny CLIP of
``tests/test_serve.py``'s ``served`` fixture in f32, the same weights
(carried across with ``params_from_jax``), the same batch; loss,
``clip_acc``, ``grad_norm`` and every updated parameter at 1e-4.  Then the
non-finite-loss skip and the logit-scale clamp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avion_tpu.core.config import OptimConfig as JaxOptimConfig
from avion_tpu.core.train_state import TrainState as JaxTrainState
from avion_tpu.models.clip import CLIP as JaxCLIP
from avion_tpu.optim.factory import build_optimizer as jax_build_optimizer
from avion_tpu.train.steps import make_clip_train_step as jax_make_step
from avion_tpu_torch.core.config import OptimConfig
from avion_tpu_torch.core.train_state import TrainState
from avion_tpu_torch.models.clip import CLIP
from avion_tpu_torch.models.pt_import import params_from_jax
from avion_tpu_torch.optim.factory import build_optimizer
from avion_tpu_torch.train.steps import LOGIT_SCALE_MAX, make_clip_train_step

SERVED = dict(embed_dim=32, image_size=32, patch_size=16, num_frames=4,
              vision_width=64, vision_layers=2, vision_heads=2,
              context_length=13, vocab_size=49408, text_width=32,
              text_heads=2, text_layers=2)
OPT = dict(lr=1e-3, lr_start=1e-4, warmup_epochs=0.5, epochs=1, wd=0.05,
           grad_clip_norm=1.0)
NITER = 4
TOL = dict(rtol=1e-4, atol=1e-4)


def _batch(n=6, seed=1):
    rs = np.random.RandomState(seed)
    video = rs.standard_normal((n, 4, 32, 32, 3)).astype(np.float32)
    text = rs.randint(1, 49000, (n, 13)).astype(np.int32)
    text[np.arange(n), rs.randint(2, 13, n)] = 49407
    return {"video": video, "text": text}


@pytest.fixture(scope="module")
def jax_setup():
    model = JaxCLIP(**SERVED, use_flash=False, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 32, 32, 3)),
                        jnp.zeros((1, 13), jnp.int32))["params"]
    rs = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rs.standard_normal(np.shape(x)).astype(np.float32), params)
    return model, params


def _port(params, remat=False):
    model = CLIP(**SERVED, dtype=torch.float32, remat=remat)
    model.load_state_dict(params_from_jax(params), strict=True)
    opt, _ = build_optimizer(OptimConfig(**OPT), model, NITER)
    return TrainState.create(model, opt), make_clip_train_step(model)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("remat", [False, True])
def test_one_step_matches_jax(jax_setup, remat):
    jm, params = jax_setup
    tx, _ = jax_build_optimizer(JaxOptimConfig(**OPT), params, NITER)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                                  tx)
    jstep = jax.jit(jax_make_step(jm, tx))
    batch = _batch()
    jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                             jax.random.PRNGKey(0))
    state, step = _port(params, remat)
    state, metrics = step(state, _torch_batch(batch))
    for key in ("loss", "clip_acc", "grad_norm", "logit_scale"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]),
                                   err_msg=key, **TOL)
    assert metrics["step_ok"] == 1.0 and state.step == 1
    ref = params_from_jax(jax.device_get(jstate.params))
    got = state.model.state_dict()
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   err_msg=k, **TOL)


def test_non_finite_loss_skips_the_update(jax_setup):
    _, params = jax_setup
    state, step = _port(params)
    state, _ = step(state, _torch_batch(_batch()))  # moments exist
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    moments = {id(p): {k: v.clone() for k, v in s.items()}
               for p, s in state.optimizer.adamw.state.items()}
    bad = _batch()
    bad["video"][:] = np.nan
    state, metrics = step(state, _torch_batch(bad))
    assert metrics["step_ok"] == 0.0
    assert not np.isfinite(float(metrics["loss"]))
    assert state.step == 2 and state.optimizer.count == 1
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for p, s in state.optimizer.adamw.state.items():
        for k, v in s.items():
            assert torch.equal(v, moments[id(p)][k]), k
    state, metrics = step(state, _torch_batch(_batch(seed=2)))
    assert metrics["step_ok"] == 1.0 and state.optimizer.count == 2


def test_logit_scale_is_clamped(jax_setup):
    _, params = jax_setup
    state, step = _port(params)
    with torch.no_grad():
        state.model.logit_scale.fill_(LOGIT_SCALE_MAX + 0.5)
    state, metrics = step(state, _torch_batch(_batch()))
    assert state.model.logit_scale.item() == pytest.approx(LOGIT_SCALE_MAX)
    assert float(metrics["logit_scale"]) == pytest.approx(
        np.exp(LOGIT_SCALE_MAX + 0.5), rel=1e-6)


def test_uint8_video_is_normalized_like_jax(jax_setup):
    """A uint8 batch goes through ``prep_video``'s normalization (f32 here,
    the model's dtype), as the JAX step's does."""
    from avion_tpu_torch.data.transforms import normalize_video

    _, params = jax_setup
    rs = np.random.RandomState(3)
    raw = rs.randint(0, 256, (4, 4, 32, 32, 3)).astype(np.uint8)
    text = _batch(4)["text"]
    a_state, step = _port(params)
    _, a = step(a_state, {"video": torch.from_numpy(raw),
                          "text": torch.from_numpy(text)})
    b_state, step = _port(params)
    _, b = step(b_state, {"video": normalize_video(
        torch.from_numpy(raw), dtype=torch.float32),
        "text": torch.from_numpy(text)})
    assert float(a["loss"]) == pytest.approx(float(b["loss"]), rel=1e-6)
