"""The VideoMAE entries' pieces over gloo groups against the JAX package on
a virtual mesh of the same shape: one pretraining step (host tube masks,
the normalized-pixel loss of the global batch) and one finetune step
(label smoothing, layer decay, the EMA) at data=2 and at fsdp=2, against
the JAX steps jitted over the conftest's CPU devices (SGD, the tolerances
of ``test_torch_parallel_finetune``); the multi-view test with its videos
split over 2 ranks on an FSDP2 model's EMA against one process; an EMA
saved at fsdp=2 restored at world 1; each rank's loader rows (tube masks,
RandAugment) against the JAX loader's rows at the same global positions;
and ``videomae_pretrain.main`` / ``videomae_finetune.main`` over 2 ranks.
Each group runs in spawned processes with a limit of 60 s
(``tests/torch_dist.py``)."""

import os.path as osp
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avion_tpu.data import datasets as jds
from avion_tpu.data.loader import DataLoader as JaxDataLoader
from avion_tpu.data.transforms import tube_mask_batch
from avion_tpu.models import videomae as jvm
from avion_tpu.train import steps as jax_steps
from avion_tpu.train.videomae_finetune import AugmentedK400 as JaxAugmented
from avion_tpu_torch.core.checkpoint import Checkpointer
from avion_tpu_torch.core.config import OptimConfig, TrainConfig
from avion_tpu_torch.core.train_state import TrainState
from avion_tpu_torch.data import datasets as pds
from avion_tpu_torch.data.loader import DataLoader
from avion_tpu_torch.models.pt_import import params_from_jax
from avion_tpu_torch.optim.factory import build_optimizer
from avion_tpu_torch.train import videomae_finetune as vf

import torch_parallel_workers as workers
from test_torch_parallel_finetune import (MESH_IDS, MESHES, OPT, check_layout,
                                          compare_step, jax_mesh_step,
                                          perturbed)
from torch_dist import run_ranks
from torch_native_decode import backend, native_decode_lib  # noqa: F401

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

def _video(n=4, seed=2):
    return np.random.RandomState(seed).standard_normal(
        (n, 4, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def pretrain_params():
    jm = jvm.PretrainVideoMAE(**workers.VMAE_PRETRAIN, use_flash=False,
                              dtype=jnp.float32)
    video = _video(1)
    mask = tube_mask_batch(np.random.RandomState(0), 1, 2, 2, 2, 0.5)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(video),
                              jnp.asarray(mask))["params"]
    return jm, perturbed(params)


@pytest.fixture(scope="module")
def finetune_params():
    jm = jvm.FinetuneVideoMAE(**workers.VMAE_FINETUNE, use_flash=False,
                              dtype=jnp.float32, drop_path_rate=0.0)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1),
                              jnp.asarray(_video(1)))["params"]
    return jm, perturbed(params, seed=1)


@pytest.mark.parametrize("data,fsdp", MESHES, ids=MESH_IDS)
def test_pretrain_step_over_ranks_matches_jax_mesh(pretrain_params, data,
                                                   fsdp):
    """Each rank's loss is the mean over its rows' masked tubes, every row
    masking 4 of 8: their average over the ranks is the global batch's."""
    jm, params = pretrain_params
    batch = {"video": _video(),
             "mask": tube_mask_batch(np.random.RandomState(3), 4, 2, 2, 2,
                                     0.5)}
    ref_metrics, ref_params, _ = jax_mesh_step(
        lambda tx: jax_steps.make_videomae_train_step(jm, tx), params, batch,
        data, fsdp)
    sd = params_from_jax(params)
    ranks = run_ranks(workers.entry_step, data * fsdp, "vmae_pretrain", sd,
                      OPT, batch, data, fsdp)
    compare_step(ranks, ref_metrics, ref_params, ("loss",))
    check_layout(ranks, "vmae_pretrain", sd, fsdp)


def test_pretrain_step_refuses_rows_that_mask_another_count():
    """The global mean needs every row to mask the model's count of tubes:
    a batch whose row masks one more raises instead of averaging unequal
    means."""
    from avion_tpu_torch.train.steps import make_videomae_train_step

    model = workers.entry_model("vmae_pretrain")
    opt, _ = build_optimizer(OptimConfig(**OPT), model, workers.NITER)
    mask = tube_mask_batch(np.random.RandomState(3), 4, 2, 2, 2, 0.5)
    mask[1, np.flatnonzero(~mask[1])[0]] = True
    with pytest.raises(RuntimeError, match="every row must mask 4 tokens"):
        make_videomae_train_step(model)(
            TrainState.create(model, opt),
            {"video": torch.from_numpy(_video()),
             "mask": torch.from_numpy(mask)})


@pytest.mark.parametrize("data,fsdp", MESHES, ids=MESH_IDS)
def test_finetune_step_over_ranks_matches_jax_mesh(finetune_params, data,
                                                   fsdp):
    """The classification step on the VideoMAE finetune model with the EMA
    (sharded with the parameters under FSDP2)."""
    jm, params = finetune_params
    batch = {"video": _video(), "label": np.array([2, 0, 4, 1], np.int32)}
    ref_metrics, ref_params, ref_ema = jax_mesh_step(
        lambda tx: jax_steps.make_cls_train_step(
            jm, tx, label_smoothing=0.1, ema_decay=0.9), params, batch,
        data, fsdp, use_ema=True)
    sd = params_from_jax(params)
    ranks = run_ranks(workers.entry_step, data * fsdp, "vmae_finetune", sd,
                      OPT, batch, data, fsdp, 0.9, 0.1)
    compare_step(ranks, ref_metrics, ref_params, ("loss", "acc1"), ref_ema)
    check_layout(ranks, "vmae_finetune", sd, fsdp)


def test_ema_saved_at_fsdp2_restores_at_world_1(finetune_params, tmp_path):
    """The EMA is sharded at rest under FSDP2; the checkpoint holds it
    whole, equal to the unsharded EMA, and a one-process state restores
    it bit for bit."""
    _, params = finetune_params
    sd = params_from_jax(params)
    out = str(tmp_path / "ckpt")
    batch = {"video": _video(), "label": np.array([2, 0, 4, 1], np.int32)}
    (whole, sharded), _ = run_ranks(workers.ema_checkpoint, 2, sd, OPT,
                                    batch, out)
    assert sharded
    model = workers.entry_model("vmae_finetune")
    opt, _ = build_optimizer(OptimConfig(**OPT), model, workers.NITER,
                             num_layers=2)
    state = TrainState.create(model, opt, use_ema=True)
    restored, _ = Checkpointer(out).restore(state)
    assert restored is state and state.step == 1
    assert state.ema.keys() == whole.keys()
    for k, v in whole.items():
        assert np.array_equal(state.ema[k].numpy(), v), k
        assert not np.array_equal(v, sd[k].numpy()), k  # it moved


@pytest.fixture(scope="module")
def k400(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("k400"))
    return root, chip_smoke.write_k400_fixture(root, videos=8, frames=24,
                                               w=64, h=48, fps=10, classes=3)


def test_multi_view_test_splits_videos_over_ranks(k400, tmp_path):
    """5 videos x 2 clips x 1 crop at val batch 2 over 2 ranks of an FSDP2
    model (blocks of 3, the last padded with the last video): the test on
    the gathered EMA equals one process's on a model holding the EMA."""
    root, meta = k400
    val = str(tmp_path / "val.txt")
    with open(meta) as f, open(val, "w") as g:
        g.writelines(f.readlines()[:5])
    args = ["model.name=VIDEOMAE_TINY_FT", "model.num_classes=3",
            f"data.root={root}", f"data.val_metadata={val}",
            "data.clip_length=4", "data.clip_stride=2",
            "data.val_batch_size=2", "data.num_clips=2", "data.num_crops=1",
            "data.num_workers=0", "use_ema=true", "data.crop_size=32"]
    cfg = TrainConfig().apply_overrides(args)
    model = vf.build_model(cfg).to_empty(device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    rs = np.random.RandomState(4)
    ema = {n: p.detach() + torch.from_numpy(
        0.1 * rs.standard_normal(p.shape).astype(np.float32))
        for n, p in model.named_parameters()}
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(ema[n])
    cfg.use_ema = False
    want = vf.validate(cfg, SimpleNamespace(state=SimpleNamespace(
        model=model, parallel=None, ema=None)))
    got = run_ranks(workers.vmae_validate, 2, args, sd, ema, 2)
    assert got[0] == got[1]
    for k in want:
        np.testing.assert_allclose(got[0][k], want[k], rtol=1e-6, err_msg=k)


@pytest.fixture
def seeded_items(monkeypatch):
    """Every training item draws from seed 0 (they seed from the OS
    otherwise)."""
    orig = np.random.RandomState
    monkeypatch.setattr(np.random, "RandomState",
                        lambda seed=None: orig(0 if seed is None else seed))


@pytest.mark.parametrize("kind", ["pretrain", "finetune"])
def test_rank_rows_match_jax_loader(k400, seeded_items, backend, kind):
    """Over 2 batch groups, each group's batches (videos, tube masks or
    RandAugment'ed views, labels) equal the JAX loader's for the same
    process: the same clips at the same global positions, decoded by the
    same backend."""
    root, meta = k400
    if kind == "pretrain":
        kw = dict(clip_length=4, clip_stride=2, crop_size=32, patch_size=16,
                  tubelet_size=2, mask_ratio=0.5)
        aug = dict(crop_size=32, mode="msc", hflip_prob=0.5)
        ours = pds.KineticsDataset(root, meta, augment=pds.AugmentSpec(**aug),
                                   **kw)
        ref = jds.KineticsDataset(root, meta, augment=jds.AugmentSpec(**aug),
                                  **kw)
    else:
        kw = dict(is_training=True, clip_length=4, clip_stride=2,
                  num_sample=2, use_randaug=True, erase_prob=0.5)
        aug = dict(crop_size=32, mode="rrc", hflip_prob=0.5)
        ours = vf.AugmentedK400("kinetics", root, meta,
                                augment=pds.AugmentSpec(**aug), **kw)
        ref = JaxAugmented("kinetics", root, meta,
                           augment=jds.AugmentSpec(**aug), **kw)
    for process in range(2):
        loader = dict(batch_size=4, shuffle=True, drop_last=True,
                      num_workers=0, seed=7, process_index=process,
                      process_count=2)
        got = list(DataLoader(ours, **loader))
        want = list(JaxDataLoader(ref, **loader))
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]), err_msg=k)
            assert a["video"].shape[0] == (2 if kind == "pretrain" else 4)


@pytest.mark.parametrize("entry,mesh", [("videomae_pretrain", "mesh.data=2"),
                                        ("videomae_finetune", "mesh.fsdp=2")])
def test_main_trains_over_ranks(k400, tmp_path, entry, mesh):
    """``main`` on 2 gloo ranks at the global batch 4: the steps, the
    finetune's test on the EMA, one checkpoint written by rank 0."""
    root, meta = k400
    out = str(tmp_path / "run")
    args = [f"data.root={root}", f"data.train_metadata={meta}",
            "data.clip_length=4", "data.clip_stride=2", "data.batch_size=4",
            "data.num_workers=0", "optim.epochs=1", "optim.lr=1e-3",
            "optim.warmup_epochs=0", f"output_dir={out}", "print_freq=1",
            mesh, "--device", "cpu"]
    if entry == "videomae_pretrain":
        args += ["model.name=VIDEOMAE_TINY", "data.mask_ratio=0.5"]
    else:
        args += ["model.name=VIDEOMAE_TINY_FT", "model.num_classes=3",
                 f"data.val_metadata={meta}", "data.val_batch_size=3",
                 "data.num_clips=2", "data.num_crops=1",
                 "optim.layer_decay=0.75", "mixup=0.8", "cutmix=1.0",
                 "smoothing=0.1", "use_ema=true", "ema_decay=0.9",
                 "eval_freq=1"]
    ranks = run_ranks(workers.entry_main, 2, entry, args)
    assert ranks[0]["steps"] == ranks[1]["steps"] == 2
    assert ranks[0]["eval"] == ranks[1]["eval"]
    if entry == "videomae_finetune":
        assert set(ranks[0]["eval"][0]) == {"acc1", "acc5"}
    losses = [r["epochs"][0]["loss"] for r in ranks]
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    assert Checkpointer(osp.join(out, "ckpt")).steps() == [2]
