"""CLIP's step with a mixture-of-experts tower inside the sequence-parallel
visual tower (gap pooling, no CLS token) over gloo ranks
(``tests/torch_dist.run_ranks``) against the JAX step on a virtual mesh of
the same shape, with CLIP_TINY in f32, 4 experts, the same weights
(``params_from_jax``) and global batch (``tests/test_torch_parallel_moe_pp``'s
harness and tolerances): at data=2 x sp=2 and at sp=2 x ep=2.  Each rank
holds 4 of a clip's 8 visual tokens; the MoE layers gather their rows'
tokens over ``sp`` and route the batch group's rows in JAX's global
``(b, s)`` order, so the router's losses and statistics are JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from optax import ScaleByAdamState

from avion_tpu.core.config import OptimConfig as JaxOptimConfig
from avion_tpu.core.train_state import TrainState as JaxTrainState
from avion_tpu.models.clip import CLIP as JaxCLIP
from avion_tpu.optim.factory import build_optimizer as jax_build_optimizer
from avion_tpu.parallel import make_mesh as jax_make_mesh
from avion_tpu.parallel.sharding import make_global_batch, shard_params
from avion_tpu.train import steps as jax_steps
from avion_tpu_torch.models.pt_import import params_from_jax

import torch_parallel_workers as workers
from test_torch_parallel_moe_pp import _check_moe_metrics, _compare
from test_torch_parallel_train import CLIP_TINY, OPT, _batch
from torch_dist import run_ranks

MOE_SP = {"moe_experts": 4}


def jax_clip_step(jm, params, batch, **axes):
    """The JAX CLIP step jitted over a mesh of the conftest's devices with
    ``axes`` (``data``, ``sp``, ``ep``, ``pp``, ``tensor``) on the global
    batch: (metrics, the updated parameters, the step's clipped gradients),
    in the port's names."""
    n = int(np.prod(list(axes.values())))
    mesh = jax_make_mesh(**axes, devices=jax.devices()[:n])
    tx, _ = jax_build_optimizer(JaxOptimConfig(**OPT), params, workers.NITER)
    with jax.set_mesh(mesh):
        state = JaxTrainState.create(
            shard_params(jax.tree_util.tree_map(jnp.asarray, params), mesh),
            tx)
        step = jax.jit(jax_steps.make_clip_train_step(jm, tx))
        state, metrics = step(state, make_global_batch(mesh, batch),
                              jax.random.PRNGKey(0))
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: isinstance(s, ScaleByAdamState))
        if isinstance(s, ScaleByAdamState)]
    b1 = JaxOptimConfig(**OPT).betas[0]
    port = lambda tree: {k: v.numpy() for k, v in params_from_jax(  # noqa
        jax.device_get(tree)).items()}
    return ({k: float(v) for k, v in metrics.items()}, port(state.params),
            {k: g / (1 - b1) for k, g in port(adam.mu).items()})


@pytest.fixture(scope="module")
def moe_sp_clip():
    jm = JaxCLIP(**CLIP_TINY, use_flash=False, dtype=jnp.float32,
                 pooling="gap", sequence_parallel=True, **MOE_SP)
    with jax.set_mesh(jax_make_mesh(data=8)):
        params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((8, 2, 32, 32, 3)),
                                  jnp.zeros((8, 77), jnp.int32))["params"]
    rs = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rs.standard_normal(np.shape(x)).astype(np.float32),
        jax.device_get(params))
    return jm, params


@pytest.mark.parametrize("data,ep", [(2, 1), (1, 2)],
                         ids=["data2-sp2", "sp2-ep2"])
def test_moe_step_in_sequence_parallel_tower_matches_jax_mesh(
        moe_sp_clip, data, ep):
    """data=2 x sp=2: a routing group of 64 tokens spans both batch groups'
    rows and both sp ranks' halves of each row; sp=2 x ep=2: each rank
    holds 2 of the 4 experts and 4 of a clip's 8 tokens.  Every gradient,
    the updated parameters and the router's metrics against JAX's; the
    router's leaves alike on every rank."""
    jm, params = moe_sp_clip
    batch = _batch()
    ref = jax_clip_step(jm, params, batch, data=data, sp=2, ep=ep)
    ranks = run_ranks(workers.train_step, 4, params_from_jax(params), OPT,
                      batch, data, 1, 1, "clip", 2, 1, 1, 1, ep, MOE_SP)
    _compare(ranks, *ref)
    _check_moe_metrics(ranks, ref[0])
    router = "visual.transformer.resblocks.0.moe_mlp.router.weight"
    held = "visual.transformer.resblocks.0.moe_mlp.expert_fc1"
    for r in ranks:
        assert r["local"][held].shape[0] == 4 // ep
        np.testing.assert_array_equal(r["local"][router],
                                      ranks[0]["local"][router])
