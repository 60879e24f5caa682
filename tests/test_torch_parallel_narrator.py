"""The narrator's train step over gloo groups against the JAX step on a
virtual mesh of the same shape (``tests/test_torch_parallel_finetune.py``'s
harness): one step of a tiny VCLM (CLIP's vocabulary, so the embedding
shards) at data=2 and at fsdp=2 (FSDP2), SGD with momentum, weight decay,
layer decay and a clip that acts, on a global batch whose rows hold
different counts of padding, so the loss is the token mean of the global
batch only if each rank weighs its tokens by the group's count.  Loss at
2e-5, parameters after the update at 1e-5 (the finetune tests'
tolerances); FSDP2 shards at rest and every parameter keeps the
one-process optimizer's layer-decay scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from avion_tpu.models.narrator import VCLM as JaxVCLM
from avion_tpu.train.train_narrator import make_narrator_step
from avion_tpu_torch.models.pt_import import params_from_jax

import torch_parallel_workers as workers
from test_torch_parallel_finetune import (MESH_IDS, MESHES, OPT,
                                          check_layout, compare_step,
                                          jax_mesh_step, perturbed)
from torch_dist import run_ranks


@pytest.fixture(scope="module")
def narrator_params():
    jm = JaxVCLM(**workers.VCLM_TINY, use_flash=False, dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 2, 32, 32, 3)),
                              jnp.zeros((1, 16), jnp.int32))["params"]
    return jm, perturbed(params)


def _batch(n=4, seed=4):
    rs = np.random.RandomState(seed)
    video = rs.standard_normal((n, 2, 32, 32, 3)).astype(np.float32)
    text = rs.randint(1, 49000, (n, 16)).astype(np.int32)
    for row, length in enumerate((16, 5, 11, 3)):  # ranks' counts differ
        text[row, length:] = 0
    return {"video": video, "text": text}


@pytest.mark.parametrize("data,fsdp", MESHES, ids=MESH_IDS)
def test_narrator_step_over_ranks_matches_jax_mesh(narrator_params, data,
                                                   fsdp):
    jm, params = narrator_params
    batch = _batch()
    ref_metrics, ref_params, _ = jax_mesh_step(
        lambda tx: make_narrator_step(jm, tx), params, batch, data, fsdp)
    sd = params_from_jax(params)
    ranks = run_ranks(workers.entry_step, data * fsdp, "narrator", sd, OPT,
                      batch, data, fsdp)
    compare_step(ranks, ref_metrics, ref_params, ("loss",))
    check_layout(ranks, "narrator", sd, fsdp)
