"""The finetune entries' pieces over gloo groups against the JAX package on
a virtual mesh of the same shape: one step of the EK100-MIR step
(CLIP_TINY, the max-margin loss over the global batch) and of the
classification step (a tiny tower's classifier, label smoothing) at
data=2 and at fsdp=2 (FSDP2), with layer decay and a gradient clip that
acts, against the JAX step jitted over the conftest's CPU devices; the
max-margin loss over 2 ranks against one process on the whole batch; mixup
/ cutmix's global flip over 2 ranks against JAX on the whole batch; the
CLS multi-view test with its clips split over 2 ranks against one
process; and ``finetune_mir.main`` / ``finetune_cls.main`` over 2 ranks.

SGD is the optimizer of the step tests, so the updated parameters are the
gradients times the learning rate (AdamW's first update would lift f32
noise to the learning rate; ``test_torch_parallel_train`` holds that
case).  Loss at 2e-5, parameters after the update at 1e-5, the
tolerances of ``test_torch_parallel_train``.  Each group runs in spawned
processes with a limit of 60 s (``tests/torch_dist.py``)."""

import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avion_tpu.core.config import OptimConfig as JaxOptimConfig
from avion_tpu.core.train_state import TrainState as JaxTrainState
from avion_tpu.losses.losses import max_margin_ranking_loss as jax_max_margin
from avion_tpu.models.clip import CLIP as JaxCLIP
from avion_tpu.models.clip import VideoClassifier as JaxVideoClassifier
from avion_tpu.models.layers import quick_gelu as jax_quick_gelu
from avion_tpu.models.vit import VisionTransformer as JaxVisionTransformer
from avion_tpu.optim.factory import build_optimizer as jax_build_optimizer
from avion_tpu.parallel import make_mesh as jax_make_mesh
from avion_tpu.parallel.sharding import make_global_batch, shard_params
from avion_tpu.train import augment_device as jad
from avion_tpu.train import steps as jax_steps
from avion_tpu_torch.core.config import OptimConfig, TrainConfig
from avion_tpu_torch.models.pt_import import params_from_jax
from avion_tpu_torch.optim.factory import build_optimizer
from avion_tpu_torch.train import augment_device as ad
from avion_tpu_torch.train import finetune_cls

import torch_parallel_workers as workers
from test_torch_parallel_train import CLIP_TINY
from test_torch_videomae_train import DRAW_CASES, _jax_draws
from torch_dist import run_ranks

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

LOSS_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)
PARAM_TOL = dict(atol=1e-5, rtol=1e-5)
OPT = dict(optimizer="sgd", lr=0.1, momentum=0.9, wd=0.05,
           warmup_epochs=0.0, epochs=1, grad_clip_norm=0.01,
           layer_decay=0.75)
MESHES = [(2, 1), (1, 2)]
MESH_IDS = ["data2", "fsdp2"]
GLOBAL_BATCH = 4


def perturbed(params, seed=0):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rs.standard_normal(np.shape(x)).astype(np.float32), params)


def jax_mesh_step(make_step, params, batch, data, fsdp, use_ema=False,
                  tensor=1, sp=1):
    """``make_step(tx)``'s step jitted over a (data, fsdp, sp, tensor) mesh
    of the conftest's CPU devices on the global ``batch``: (metrics, the
    updated parameters and EMA in the port's names)."""
    mesh = jax_make_mesh(data=data, fsdp=fsdp, tensor=tensor, sp=sp,
                         devices=jax.devices()[:data * fsdp * tensor * sp])
    tx, _ = jax_build_optimizer(JaxOptimConfig(**OPT), params, workers.NITER,
                                num_layers=2)
    with jax.set_mesh(mesh):
        state = JaxTrainState.create(
            shard_params(jax.tree_util.tree_map(jnp.asarray, params), mesh),
            tx, use_ema=use_ema)
        state, metrics = jax.jit(make_step(tx))(
            state, make_global_batch(mesh, batch), jax.random.PRNGKey(0))
    port = lambda tree: {k: v.numpy() for k, v in params_from_jax(  # noqa
        jax.device_get(tree)).items()}
    return ({k: float(v) for k, v in metrics.items()}, port(state.params),
            port(state.ema_params) if use_ema else None)


def compare_step(ranks, ref_metrics, ref_params, keys, ref_ema=None):
    for r in ranks:
        for key in keys:
            np.testing.assert_allclose(r["metrics"][key], ref_metrics[key],
                                       err_msg=key, **LOSS_TOL)
        assert r["metrics"]["step_ok"] == 1.0
    for name, want in (("params", ref_params), ("ema", ref_ema)):
        if want is None:
            continue
        got = ranks[0][name]
        assert got.keys() == want.keys()
        for k, ref in want.items():
            np.testing.assert_allclose(got[k], ref, err_msg=f"{name} {k}",
                                       **PARAM_TOL)


def check_layout(ranks, kind, sd, fsdp):
    """FSDP2 shards at rest; the layer-decay scale of every parameter (its
    name under DDP / FSDP2) is the one-process optimizer's."""
    model = workers.entry_model(kind)
    model.load_state_dict(sd, strict=True)
    opt, _ = build_optimizer(OptimConfig(**OPT), model, workers.NITER,
                             num_layers=2)
    names = {id(p): n for n, p in model.named_parameters()}
    want = {names[id(p)]: g["lr_scale"]
            for g in opt.inner.param_groups for p in g["params"]}
    assert len(set(want.values())) == 4  # embeddings, 2 blocks, the rest
    for r in ranks:
        assert r["sharded"] == (fsdp > 1)
        assert r["scales"] == want


def _clip_batch(n=GLOBAL_BATCH, seed=1):
    rs = np.random.RandomState(seed)
    video = rs.standard_normal((n, 2, 32, 32, 3)).astype(np.float32)
    text = rs.randint(1, 49000, (n, 77)).astype(np.int32)
    text[np.arange(n), rs.randint(2, 77, n)] = 49407
    return {"video": video, "text": text}


@pytest.fixture(scope="module")
def mir_params():
    jm = JaxCLIP(**CLIP_TINY, use_flash=False, dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 2, 32, 32, 3)),
                              jnp.zeros((1, 77), jnp.int32))["params"]
    return jm, perturbed(params)


@pytest.fixture(scope="module")
def cls_params():
    jm = JaxVideoClassifier(JaxVisionTransformer(
        **workers.TINY_TOWER, output_dim=None, act=jax_quick_gelu,
        dtype=jnp.float32, use_flash=False, pooling="cls"), num_classes=5,
        dropout=0.0)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 2, 32, 32, 3)))["params"]
    return jm, perturbed(params)


@pytest.mark.parametrize("data,fsdp", MESHES, ids=MESH_IDS)
def test_mir_step_over_ranks_matches_jax_mesh(mir_params, data, fsdp):
    """The max-margin loss of the global batch; the logit scale takes no
    gradient (DDP looks for it, FSDP2 leaves it without one on every
    rank)."""
    jm, params = mir_params
    batch = _clip_batch()
    ref_metrics, ref_params, _ = jax_mesh_step(
        lambda tx: jax_steps.make_mir_finetune_step(jm, tx), params, batch,
        data, fsdp)
    sd = params_from_jax(params)
    ranks = run_ranks(workers.entry_step, data * fsdp, "mir", sd, OPT, batch,
                      data, fsdp)
    compare_step(ranks, ref_metrics, ref_params, ("loss", "max_margin_loss"))
    np.testing.assert_array_equal(ranks[0]["params"]["logit_scale"],
                                  sd["logit_scale"].numpy())
    check_layout(ranks, "mir", sd, fsdp)


@pytest.mark.parametrize("data,fsdp", MESHES, ids=MESH_IDS)
def test_cls_step_over_ranks_matches_jax_mesh(cls_params, data, fsdp):
    """Label smoothing, SGD with momentum and layer decay: the global
    batch's mean cross-entropy and accuracy on every rank."""
    jm, params = cls_params
    rs = np.random.RandomState(2)
    batch = {"video": rs.standard_normal(
        (GLOBAL_BATCH, 2, 32, 32, 3)).astype(np.float32),
        "label": np.array([0, 3, 1, 4], np.int32)}
    ref_metrics, ref_params, _ = jax_mesh_step(
        lambda tx: jax_steps.make_cls_train_step(jm, tx,
                                                 label_smoothing=0.1),
        params, batch, data, fsdp)
    sd = params_from_jax(params)
    ranks = run_ranks(workers.entry_step, data * fsdp, "cls", sd, OPT, batch,
                      data, fsdp, None, 0.1)
    compare_step(ranks, ref_metrics, ref_params, ("loss", "acc1"))
    check_layout(ranks, "cls", sd, fsdp)


def test_max_margin_loss_over_ranks_matches_one_process():
    """Value over 2 ranks = the loss of the concatenated batch; each rank's
    embedding gradient, divided by the group's size as DDP averages, = the
    one-process gradient of its rows; and JAX's loss on the whole batch."""
    rs = np.random.RandomState(3)
    img = rs.standard_normal((6, 16)).astype(np.float32)
    txt = rs.standard_normal((6, 16)).astype(np.float32)
    from avion_tpu_torch.losses.losses import max_margin_ranking_loss

    zi = torch.from_numpy(img).requires_grad_()
    zt = torch.from_numpy(txt).requires_grad_()
    loss = max_margin_ranking_loss(zi, zt)["loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jax_max_margin(
        jnp.asarray(img), jnp.asarray(txt))["loss"]), **LOSS_TOL)
    ranks = run_ranks(workers.max_margin, 2, img, txt)
    for r, got in enumerate(ranks):
        rows = slice(3 * r, 3 * (r + 1))
        np.testing.assert_allclose(got["loss"], loss.item(), **LOSS_TOL)
        np.testing.assert_allclose(got["d_img"] / 2, zi.grad[rows].numpy(),
                                   **GRAD_TOL)
        np.testing.assert_allclose(got["d_txt"] / 2, zt.grad[rows].numpy(),
                                   **GRAD_TOL)


@pytest.mark.parametrize("prefix", ["", "module."])
def test_layer_decay_depth_reads_wrapped_names(prefix):
    """DDP's ``module.`` prefix leaves each name's depth as it is (the
    optimizer is built over the unwrapped module; FSDP2 keeps its names,
    ``check_layout``)."""
    from avion_tpu_torch.optim.factory import block_depth

    for name, depth in (("visual.transformer.resblocks.1.attn.Wqkv.weight",
                         2), ("visual.conv1.weight", 0),
                        ("encoder.resblocks.0.mlp.fc1.bias", 1),
                        ("textual.token_embedding.weight", 0),
                        ("fc_cls.weight", 3), ("logit_scale", 3)):
        assert block_depth(prefix + name, 2) == depth, name


# JAX's pair mode raises (test_torch_videomae_train), so the pair case
# holds the ranks against the port's one-process mix on the same draws
MIX_MODES = {"batch": dict(mode="batch"), "elem": dict(mode="elem", prob=0.6),
             "pair": DRAW_CASES["pair"]}


@pytest.mark.parametrize("case", list(MIX_MODES))
def test_mixup_flips_the_global_batch_over_ranks(case):
    """8 rows over 2 ranks: the partner of global row i is row 7 - i, on
    the other rank.  ``apply_mix`` on each rank's rows of JAX's draws
    gives JAX's ``mixup_cutmix`` of the whole batch (the port's one-process
    mix for ``pair``); ``mixup_cutmix`` with one seed on both ranks gives
    the rows of the one-process draw of the whole batch."""
    kw = dict(mixup_alpha=0.8, cutmix_alpha=1.0, switch_prob=0.5, prob=1.0,
              mode="batch", cutmix_minmax=None)
    kw.update(MIX_MODES[case])
    rs = np.random.RandomState(9)
    video = rs.randn(8, 2, 16, 24, 3).astype(np.float32)
    labels = rs.randint(0, 7, 8).astype(np.int64)
    key = jax.random.PRNGKey(3)
    if case == "pair":
        draws = [x.numpy() for x in ad.draw_mix(
            torch.Generator().manual_seed(5), 8, 16, 24,
            **{k: v for k, v in kw.items()})]
        want = ad.apply_mix(torch.from_numpy(video),
                            torch.from_numpy(labels), 7, 0.1,
                            *[torch.from_numpy(d) for d in draws])
        want = [x.numpy() for x in want]
    else:
        draws = [x.numpy() for x in _jax_draws(
            key, 8, 16, 24, kw["mixup_alpha"], kw["cutmix_alpha"],
            kw["switch_prob"], kw["prob"], kw["mode"], kw["cutmix_minmax"])]
        want = [np.asarray(x) for x in jad.mixup_cutmix(
            key, jnp.asarray(video), jnp.asarray(labels, jnp.int32), 7,
            smoothing=0.1, **kw)]
    drawn = ad.mixup_cutmix(torch.Generator().manual_seed(11),
                            torch.from_numpy(video), torch.from_numpy(labels),
                            7, smoothing=0.1, **kw)
    ranks = run_ranks(workers.mix, 2, video, labels, draws, 11, kw)
    for name, ref in (("apply", want), ("drawn", [x.numpy() for x in drawn])):
        got = [np.concatenate([r[name][i] for r in ranks]) for i in (0, 1)]
        np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-6,
                                   err_msg=f"{name} video")
        np.testing.assert_allclose(got[1], ref[1], rtol=1e-6, atol=1e-6,
                                   err_msg=f"{name} targets")


CHUNK = 2


@pytest.fixture(scope="module")
def ek100(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ek100"))
    fx = chip_smoke.write_ek100_fixture(root, w=64, h=48, fps=10,
                                        chunk_s=CHUNK, train_clips=8,
                                        test_clips=5)
    ckpt = osp.join(root, "clip_tiny.pt")
    from avion_tpu_torch.models.registry import create_model

    model = create_model("CLIP_TINY").init_weights(
        torch.Generator().manual_seed(5))
    torch.save({"state_dict": model.state_dict()}, ckpt)
    return fx, ckpt


def _data_args(fx, *extra):
    return [f"data.root={fx['root']}", f"data.train_metadata={fx['train']}",
            f"data.val_metadata={fx['test']}", f"data.chunk_len={CHUNK}",
            "data.clip_length=2", "data.crop_size=32", "data.batch_size=4",
            "data.val_batch_size=2", "data.num_workers=0", "optim.epochs=1",
            "optim.warmup_epochs=0", "print_freq=1", "eval_freq=1", *extra]


def test_cls_multi_view_test_splits_clips_over_ranks(ek100):
    """5 test clips, 2 views each, at val batch 2 over 2 ranks (blocks of
    3, the last padded with the last clip; 2 forwards a rank): the metrics
    of one process."""
    fx, _ = ek100
    args = _data_args(fx, f"data.label_map={fx['actions']}",
                      "data.num_clips=2")
    cfg = finetune_cls.env_defaults(TrainConfig().apply_overrides(args))
    _, pairs, _ = finetune_cls.load_actions(fx["actions"])
    w = (np.random.RandomState(0).standard_normal((2 * 32 * 32 * 3,
                                                   len(pairs)))
         * 0.05).astype(np.float32)
    want = run_ranks(workers.cls_validate, 1, args, w)[0]
    got = run_ranks(workers.cls_validate, 2, args, w)
    assert got[0] == got[1] == want
    assert set(want) >= {"acc1", "acc5", "verb_acc1", "noun_acc1"}


@pytest.mark.parametrize("entry,mesh", [("finetune_mir", "mesh.fsdp=2"),
                                        ("finetune_cls", "mesh.data=2")])
def test_main_trains_and_validates_over_ranks(ek100, tmp_path, entry, mesh):
    """``main`` on 2 gloo ranks: two steps of the global batch 4 (2 rows a
    rank), the validation (MIR on a gathered copy of the FSDP2 model), one
    checkpoint written by rank 0."""
    fx, ckpt = ek100
    out = str(tmp_path / "run")
    if entry == "finetune_mir":
        args = ["model.name=CLIP_TINY", "model.project_embed_dim=32",
                f"data.relevancy_path={fx['relevancy']}", "optim.lr=1e-4"]
    else:
        args = ["model.image_size=32", "model.vision_width=64",
                "model.vision_layers=2", "model.vision_heads=2",
                f"data.label_map={fx['actions']}", "data.num_clips=2",
                "optim.optimizer=sgd", "optim.lr=0.012", "mixup=0.8"]
    args += [f"pretrain_model={ckpt}", f"output_dir={out}", mesh,
             *_data_args(fx), "--device", "cpu"]
    ranks = run_ranks(workers.entry_main, 2, entry, args)
    assert ranks[0]["steps"] == ranks[1]["steps"] == 2
    assert ranks[0]["eval"] == ranks[1]["eval"] and ranks[0]["eval"][0]
    # the logged metrics are the global batch's, alike on both ranks
    metrics = [{k: v for k, v in r["epochs"][0].items()
                if k in ("loss", "max_margin_loss", "acc1")} for r in ranks]
    assert metrics[0] == metrics[1] and np.isfinite(metrics[0]["loss"])
    from avion_tpu_torch.core.checkpoint import Checkpointer

    assert Checkpointer(osp.join(out, "ckpt")).steps() == [2]
