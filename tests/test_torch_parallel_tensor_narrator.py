"""The narrator's step at ``mesh.tensor=2`` over 4 gloo ranks (data=2 x
tensor=2) against the JAX step on a virtual mesh of the same shape
(``tests/test_torch_parallel_narrator``'s harness and batch: rows with
different padding, SGD, layer decay, a clip that acts; loss 2e-5,
parameters 1e-5): the tiny VCLM's decoder MLPs and visual tower cut."""

from avion_tpu.train.train_narrator import make_narrator_step
from avion_tpu_torch.models.pt_import import params_from_jax

import torch_parallel_workers as workers
from test_torch_parallel_finetune import (OPT, check_layout, compare_step,
                                          jax_mesh_step)
from test_torch_parallel_narrator import _batch, narrator_params  # noqa: F401
from torch_dist import run_ranks


def test_narrator_step_at_tensor_2_matches_jax_mesh(narrator_params):  # noqa: F811
    jm, params = narrator_params
    batch = _batch()
    ref_metrics, ref_params, _ = jax_mesh_step(
        lambda tx: make_narrator_step(jm, tx), params, batch, 2, 1,
        tensor=2)
    sd = params_from_jax(params)
    ranks = run_ranks(workers.entry_step, 4, "narrator", sd, OPT, batch, 2,
                      1, None, 0.0, 2)
    compare_step(ranks, ref_metrics, ref_params, ("loss",))
    check_layout(ranks, "narrator", sd, 1)
