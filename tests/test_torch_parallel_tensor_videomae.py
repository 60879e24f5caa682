"""The VideoMAE entries' steps at ``mesh.tensor=2`` over 4 gloo ranks
(data=2 x tensor=2) against the JAX steps on a virtual mesh of the same
shape (``tests/test_torch_parallel_videomae``'s harness and tolerances):
one pretraining step (host tube masks; the encoder's heads cut, the
decoder's attention whole and its MLP cut), one with a decoder of 3 heads
(as ``VIDEOMAE_VITB16_H128``'s: tensor=2 cuts its ``qkv`` into JAX's
column blocks, gathered whole for the attention) and one finetune step
with the EMA (held in parts, as its parameters)."""

import jax
import jax.numpy as jnp
import numpy as np
from avion_tpu.models import videomae as jvm
from avion_tpu.data.transforms import tube_mask_batch
from avion_tpu.train import steps as jax_steps
from avion_tpu_torch.models.pt_import import params_from_jax

import torch_parallel_workers as workers
from test_torch_parallel_finetune import OPT, check_layout, compare_step
from test_torch_parallel_finetune import jax_mesh_step, perturbed
from test_torch_parallel_videomae import (_video,  # noqa: F401
                                          finetune_params, pretrain_params)
from torch_dist import run_ranks


def test_pretrain_step_at_tensor_2_matches_jax_mesh(pretrain_params):  # noqa: F811
    jm, params = pretrain_params
    batch = {"video": _video(),
             "mask": tube_mask_batch(np.random.RandomState(3), 4, 2, 2, 2,
                                     0.5)}
    ref_metrics, ref_params, _ = jax_mesh_step(
        lambda tx: jax_steps.make_videomae_train_step(jm, tx), params, batch,
        2, 1, tensor=2)
    sd = params_from_jax(params)
    ranks = run_ranks(workers.entry_step, 4, "vmae_pretrain", sd, OPT, batch,
                      2, 1, None, 0.0, 2)
    compare_step(ranks, ref_metrics, ref_params, ("loss",))
    check_layout(ranks, "vmae_pretrain", sd, 1)


def test_finetune_step_at_tensor_2_matches_jax_mesh(finetune_params):  # noqa: F811
    jm, params = finetune_params
    batch = {"video": _video(), "label": np.array([2, 0, 4, 1], np.int32)}
    ref_metrics, ref_params, ref_ema = jax_mesh_step(
        lambda tx: jax_steps.make_cls_train_step(
            jm, tx, label_smoothing=0.1, ema_decay=0.9), params, batch,
        2, 1, use_ema=True, tensor=2)
    sd = params_from_jax(params)
    ranks = run_ranks(workers.entry_step, 4, "vmae_finetune", sd, OPT, batch,
                      2, 1, 0.9, 0.1, 2)
    compare_step(ranks, ref_metrics, ref_params, ("loss", "acc1"), ref_ema)
    check_layout(ranks, "vmae_finetune", sd, 1)


def test_pretrain_step_with_uncut_heads_at_tensor_2_matches_jax_mesh():
    """The decoder's 3 heads do not divide by tensor=2: the port holds
    JAX's contiguous blocks of its ``qkv`` columns, gathers the projection
    whole, runs all 3 heads and cuts ``out_proj`` by rows, as JAX."""
    jm = jvm.PretrainVideoMAE(**workers.VMAE_PRETRAIN_H3, use_flash=False,
                              dtype=jnp.float32)
    mask = tube_mask_batch(np.random.RandomState(0), 1, 2, 2, 2, 0.5)
    params = perturbed(jax.jit(jm.init)(
        jax.random.PRNGKey(2), jnp.asarray(_video(1)),
        jnp.asarray(mask))["params"], seed=2)
    batch = {"video": _video(),
             "mask": tube_mask_batch(np.random.RandomState(3), 4, 2, 2, 2,
                                     0.5)}
    ref_metrics, ref_params, _ = jax_mesh_step(
        lambda tx: jax_steps.make_videomae_train_step(jm, tx), params, batch,
        2, 1, tensor=2)
    sd = params_from_jax(params)
    ranks = run_ranks(workers.entry_step, 4, "vmae_pretrain_h3", sd, OPT,
                      batch, 2, 1, None, 0.0, 2)
    compare_step(ranks, ref_metrics, ref_params, ("loss",))
