"""The five entries other than ``pretrain_clip`` at ``mesh.sp=2`` over 4
gloo ranks (data=2 x sp=2) against the JAX steps on a virtual mesh of the
same shape: none of them builds a sequence-parallel model, so the ``sp``
ranks of a batch group read its rows and compute the same step, as the
JAX devices of that axis do; DDP averages over all four ranks and the
losses gather over the ranks of one ``sp`` index.  The finetune harness's
tolerances (loss 2e-5, parameters 1e-5).  These replace the refusals of
``mesh.sp`` that the entries raised before."""

import numpy as np
import pytest

from avion_tpu.data.transforms import tube_mask_batch
from avion_tpu.train import steps as jax_steps
from avion_tpu.train.train_narrator import make_narrator_step
from avion_tpu_torch.models.pt_import import params_from_jax

import torch_parallel_workers as workers
from test_torch_parallel_finetune import (OPT, _clip_batch,  # noqa: F401
                                          check_layout, cls_params,
                                          compare_step, jax_mesh_step,
                                          mir_params)
from test_torch_parallel_narrator import _batch as _narrator_batch
from test_torch_parallel_narrator import narrator_params  # noqa: F401
from test_torch_parallel_videomae import (_video,  # noqa: F401
                                          finetune_params, pretrain_params)
from torch_dist import run_ranks


def _cases(request, entry):
    """(JAX step maker, params fixture, batch, worker kind, ema, smoothing,
    compared metrics) of an entry."""
    rs = np.random.RandomState(2)
    if entry == "finetune_mir":
        jm, params = request.getfixturevalue("mir_params")
        return (jm, params, _clip_batch(), "mir", None, 0.0,
                lambda tx: jax_steps.make_mir_finetune_step(jm, tx),
                ("loss", "max_margin_loss"))
    if entry == "finetune_cls":
        jm, params = request.getfixturevalue("cls_params")
        batch = {"video": rs.standard_normal((4, 2, 32, 32, 3)).astype(
            np.float32), "label": np.array([0, 3, 1, 4], np.int32)}
        return (jm, params, batch, "cls", None, 0.1,
                lambda tx: jax_steps.make_cls_train_step(
                    jm, tx, label_smoothing=0.1), ("loss", "acc1"))
    if entry == "videomae_pretrain":
        jm, params = request.getfixturevalue("pretrain_params")
        batch = {"video": _video(), "mask": tube_mask_batch(
            np.random.RandomState(3), 4, 2, 2, 2, 0.5)}
        return (jm, params, batch, "vmae_pretrain", None, 0.0,
                lambda tx: jax_steps.make_videomae_train_step(jm, tx),
                ("loss",))
    if entry == "videomae_finetune":
        jm, params = request.getfixturevalue("finetune_params")
        batch = {"video": _video(), "label": np.array([2, 0, 4, 1],
                                                      np.int32)}
        return (jm, params, batch, "vmae_finetune", 0.9, 0.1,
                lambda tx: jax_steps.make_cls_train_step(
                    jm, tx, label_smoothing=0.1, ema_decay=0.9),
                ("loss", "acc1"))
    jm, params = request.getfixturevalue("narrator_params")
    return (jm, params, _narrator_batch(), "narrator", None, 0.0,
            lambda tx: make_narrator_step(jm, tx), ("loss",))


@pytest.mark.parametrize("entry", ["finetune_mir", "finetune_cls",
                                   "videomae_pretrain", "videomae_finetune",
                                   "train_narrator"])
def test_entry_step_at_sp_2_matches_jax_mesh(request, entry):
    jm, params, batch, kind, ema, smoothing, make, keys = _cases(request,
                                                                 entry)
    ref_metrics, ref_params, ref_ema = jax_mesh_step(
        make, params, batch, 2, 1, use_ema=ema is not None, sp=2)
    sd = params_from_jax(params)
    ranks = run_ranks(workers.entry_step, 4, kind, sd, OPT, batch, 2, 1,
                      ema, smoothing, 1, 2)
    compare_step(ranks, ref_metrics, ref_params, keys, ref_ema)
    check_layout(ranks, kind, sd, 1)
