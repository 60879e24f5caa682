"""A pipelined stack under ``mesh.tensor``: CLIP's step with the pipelined
visual tower and the narrator's step with the VCLM's pipelined decoder at
pp=2 x tensor=2 over 4 gloo ranks (``tests/torch_dist.run_ranks``) against
the JAX step on a virtual mesh of the same shape, in f32 from the same
weights (``params_from_jax``) and global batch.  A stage's blocks are whole
on both tensor ranks of it (JAX's pipeline map holds them whole) and
placeholders on the other stage; the layers outside the stack (the text
tower, the projections) keep Megatron's layout.  CLIP: the harness and
tolerances of ``tests/test_torch_parallel_moe_pp`` (AdamW; every gradient,
the updated parameters); the narrator: those of
``tests/test_torch_parallel_narrator`` (SGD, layer decay, a clip that
acts; loss 2e-5, parameters 1e-5) without weight decay: JAX decays the
pipelined decoder's group-stacked LayerNorm leaves, which are 2-D there,
and the port's per-block ones are 1-D and not decayed (``ROADMAP.md``,
documented differences)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from avion_tpu.core.config import OptimConfig as JaxOptimConfig
from avion_tpu.core.train_state import TrainState as JaxTrainState
from avion_tpu.models.narrator import VCLM as JaxVCLM
from avion_tpu.optim.factory import build_optimizer as jax_build_optimizer
from avion_tpu.parallel import make_mesh as jax_make_mesh
from avion_tpu.parallel.sharding import make_global_batch, shard_params
from avion_tpu.train.train_narrator import make_narrator_step
from avion_tpu_torch.models.pt_import import params_from_jax

import torch_parallel_workers as workers
from test_torch_parallel_finetune import OPT as FT_OPT
from test_torch_parallel_finetune import compare_step, perturbed
from test_torch_parallel_moe_pp import PIPE, _compare, _jax_params
from test_torch_parallel_moe_sp import jax_clip_step
from test_torch_parallel_narrator import _batch as narrator_batch
from test_torch_parallel_train import OPT, _batch
from torch_dist import run_ranks

NR_OPT = dict(FT_OPT, wd=0.0)
STAGE_LEAF = "visual.transformer.resblocks.1.attn.Wqkv.weight"
TEXT_CUT = "textual.transformer.resblocks.0.mlp.fc1.weight"


def test_pipelined_clip_step_at_pp_2_tensor_2_matches_jax_mesh():
    """The pipelined visual tower (2 blocks, one a stage, 2 microbatches):
    every gradient and the updated parameters against JAX's; a stage's
    leaves whole on both tensor ranks of its stage, the text tower's
    ``fc1`` cut by columns."""
    jm, params = _jax_params(PIPE)
    batch = _batch()
    ref = jax_clip_step(jm, params, batch, data=1, tensor=2, pp=2)
    ranks = run_ranks(workers.train_step, 4, params_from_jax(params), OPT,
                      batch, 1, 1, 1, "clip", 1, 2, 1, 2, 1, PIPE)
    _compare(ranks, *ref)
    for rank, r in enumerate(ranks):
        stage = rank // 2  # the mesh's rank order: pp before tensor
        assert r["local"][STAGE_LEAF].shape[0] == (192 if stage else 0)
        assert r["local"][TEXT_CUT].shape[0] == 64  # of 128 columns
    # the two tensor ranks of stage 1 hold the same updated stage leaves
    np.testing.assert_array_equal(ranks[2]["local"][STAGE_LEAF],
                                  ranks[3]["local"][STAGE_LEAF])


@pytest.fixture(scope="module")
def vclm_pp():
    jm = JaxVCLM(**workers.VCLM_TINY, use_flash=False, dtype=jnp.float32,
                 pipeline=True, pipeline_microbatches=2)
    with jax.set_mesh(jax_make_mesh(data=4, pp=2)):
        params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((4, 2, 32, 32, 3)),
                                  jnp.zeros((4, 16), jnp.int32))["params"]
    return jm, perturbed(jax.device_get(params))


def _jax_narrator_step(jm, params, batch, **axes):
    """``make_narrator_step`` jitted over a mesh of ``axes`` with
    :data:`NR_OPT` (layer decay over 2 layers): (metrics, the updated
    parameters in the port's names)."""
    n = int(np.prod(list(axes.values())))
    mesh = jax_make_mesh(**axes, devices=jax.devices()[:n])
    tx, _ = jax_build_optimizer(JaxOptimConfig(**NR_OPT), params,
                                workers.NITER, num_layers=2)
    with jax.set_mesh(mesh):
        state = JaxTrainState.create(
            shard_params(jax.tree_util.tree_map(jnp.asarray, params), mesh),
            tx)
        state, metrics = jax.jit(make_narrator_step(jm, tx))(
            state, make_global_batch(mesh, batch), jax.random.PRNGKey(0))
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.numpy() for k, v in params_from_jax(
                jax.device_get(state.params)).items()})


def test_pipelined_narrator_step_at_pp_2_tensor_2_matches_jax_mesh(vclm_pp):
    """The VCLM's decoder (2 groups, one a stage, 2 microbatches) pipelined
    under tensor=2: loss and the updated parameters against JAX's, the
    visual tower (cut over tensor) reached through the decoder's
    cross-attention."""
    jm, params = vclm_pp
    batch = narrator_batch()
    ref_metrics, ref_params = _jax_narrator_step(jm, params, batch, data=1,
                                                 tensor=2, pp=2)
    sd = params_from_jax(params)
    ranks = run_ranks(workers.entry_step, 4, "narrator_pp", sd, NR_OPT,
                      batch, 1, 1, None, 0.0, 2, 1, 2)
    compare_step(ranks, ref_metrics, ref_params, ("loss",))
