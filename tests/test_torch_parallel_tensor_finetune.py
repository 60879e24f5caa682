"""The finetune entries' steps at ``mesh.tensor=2`` over 4 gloo ranks
(data=2 x tensor=2) against the JAX steps on a virtual mesh of the same
shape (``tests/test_torch_parallel_finetune``'s harness: SGD with
momentum, layer decay, a clip that acts; loss 2e-5, parameters 1e-5): the
EK100-MIR step on CLIP_TINY and the classification step on a tiny tower.
JAX's own ``tensor`` test holds losses within 1e-4 relative
(``tests/test_tensor_parallel.py``); the port is held to the tighter
bound."""

import numpy as np

from avion_tpu.train import steps as jax_steps
from avion_tpu_torch.models.pt_import import params_from_jax

import torch_parallel_workers as workers
from test_torch_parallel_finetune import (OPT, _clip_batch,  # noqa: F401
                                          check_layout, cls_params,
                                          compare_step, jax_mesh_step,
                                          mir_params)
from torch_dist import run_ranks


def test_mir_step_at_tensor_2_matches_jax_mesh(mir_params):  # noqa: F811
    jm, params = mir_params
    batch = _clip_batch()
    ref_metrics, ref_params, _ = jax_mesh_step(
        lambda tx: jax_steps.make_mir_finetune_step(jm, tx), params, batch,
        2, 1, tensor=2)
    sd = params_from_jax(params)
    ranks = run_ranks(workers.entry_step, 4, "mir", sd, OPT, batch, 2, 1,
                      None, 0.0, 2)
    compare_step(ranks, ref_metrics, ref_params, ("loss", "max_margin_loss"))
    check_layout(ranks, "mir", sd, 1)


def test_cls_step_at_tensor_2_matches_jax_mesh(cls_params):  # noqa: F811
    jm, params = cls_params
    rs = np.random.RandomState(2)
    batch = {"video": rs.standard_normal((4, 2, 32, 32, 3)).astype(
        np.float32), "label": np.array([0, 3, 1, 4], np.int32)}
    ref_metrics, ref_params, _ = jax_mesh_step(
        lambda tx: jax_steps.make_cls_train_step(jm, tx,
                                                 label_smoothing=0.1),
        params, batch, 2, 1, tensor=2)
    sd = params_from_jax(params)
    ranks = run_ranks(workers.entry_step, 4, "cls", sd, OPT, batch, 2, 1,
                      None, 0.1, 2)
    compare_step(ranks, ref_metrics, ref_params, ("loss", "acc1"))
    check_layout(ranks, "cls", sd, 1)
