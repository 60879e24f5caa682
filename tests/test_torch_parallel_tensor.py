"""``mesh.tensor`` in the port (``parallel.tensor_parallel``) against the
JAX package's rule (``avion_tpu.parallel.sharding._spec_for_param``):

- the parameters a rank holds in part are the leaves JAX gives
  ``tensor``, for each family of the training entries (CLIP ViT-B/16 and
  its text tower, VideoMAE pretraining and finetuning, the classifier, the
  VCLM): by name at width 128 (the names carried by ``params_from_jax``),
  by shape and dim at full size;
- the fused ``Wqkv`` cut by heads, and, where ``tensor`` does not divide
  the heads, held in JAX's contiguous blocks of its columns;
- the leaves without a partner (gathered on use) listed for each family;
- a block and the narrator's cross-attention cut over 2 and 4 gloo ranks
  against the whole module (f32: output and gradients at 1e-5);
- the random draws of a step equal on the tensor ranks of a batch group;
- a checkpoint written at tensor=2 (and fsdp=2 x tensor=2) restored at
  world 1, and one written at world 1 restored at tensor=2; the eval
  copy (``whole_model``) of a cut model whole on every rank.

Each group runs in spawned processes with a limit of 60 s
(``tests/torch_dist.py``)."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avion_tpu.models import create_model as jax_create_model
from avion_tpu.models.clip import CLIP as JaxCLIP
from avion_tpu.models.clip import VideoClassifier as JaxVideoClassifier
from avion_tpu.models.narrator import VCLM as JaxVCLM
from avion_tpu.models.videomae import FinetuneVideoMAE as JaxFinetuneVMAE
from avion_tpu.models.videomae import PretrainVideoMAE as JaxPretrainVMAE
from avion_tpu.models.vit import VisionTransformer as JaxViT
from avion_tpu.parallel import make_mesh as jax_make_mesh
from avion_tpu.parallel.sharding import _spec_for_param
from avion_tpu_torch.models import videomae as vm
from avion_tpu_torch.models.clip import CLIP, VideoClassifier
from avion_tpu_torch.models.narrator import VCLM
from avion_tpu_torch.models.pt_import import params_from_jax
from avion_tpu_torch.models.registry import create_model
from avion_tpu_torch.models.vit import VisionTransformer
from avion_tpu_torch.parallel.mesh import make_mesh
from avion_tpu_torch.parallel.tensor_parallel import tensor_parallelize

import torch_parallel_workers as workers
from test_torch_parallel_train import CLIP_TINY, OPT, _batch
from torch_dist import run_ranks

W128_CLIP = dict(CLIP_TINY, vision_width=128, text_width=128, vision_heads=4,
                 text_heads=4, vision_layers=1, text_layers=1)
W128_TOWER = dict(image_size=32, patch_size=16, num_frames=2, width=128,
                  layers=1, heads=4)
W128_VMAE = dict(workers.VMAE_GEOMETRY, encoder_width=128, encoder_layers=1,
                 encoder_heads=4, decoder_width=128, decoder_layers=1,
                 decoder_heads=4, mask_ratio=0.5)
W128_VMAE_FT = dict(workers.VMAE_GEOMETRY, width=128, layers=1, heads=4,
                    num_classes=5)
W128_VCLM = dict(workers.VCLM_TINY, width=128, heads=4, vision_width=128,
                 vision_heads=4, layers=1, vision_layers=1)
VIDEO2 = jnp.zeros((1, 2, 32, 32, 3))
VIDEO4 = jnp.zeros((1, 4, 32, 32, 3))


def _mask(n_patches, n_visible):
    m = np.zeros((1, n_patches), bool)
    m[:, n_visible:] = True
    return jnp.asarray(m)


def _families_w128():
    """(JAX module, its init arguments, the port module) for each family
    at width 128, f32."""
    jvit = JaxViT(**W128_TOWER, output_dim=None, dtype=jnp.float32,
                  use_flash=False, pooling="cls")
    jpre = JaxPretrainVMAE(**W128_VMAE, use_flash=False, dtype=jnp.float32)
    return {
        "clip": (JaxCLIP(**W128_CLIP, use_flash=False, dtype=jnp.float32),
                 (VIDEO2, jnp.zeros((1, 77), jnp.int32)),
                 lambda: CLIP(**W128_CLIP, dtype=torch.float32)),
        "cls": (JaxVideoClassifier(jvit, num_classes=5, dropout=0.0),
                (VIDEO2,),
                lambda: VideoClassifier(VisionTransformer(
                    **W128_TOWER, dtype=torch.float32, pooling="cls"),
                    num_classes=5)),
        "vmae_pretrain": (jpre, (VIDEO4, _mask(8, 4)),
                          lambda: vm.PretrainVideoMAE(**W128_VMAE,
                                                      dtype=torch.float32)),
        "vmae_finetune": (JaxFinetuneVMAE(**W128_VMAE_FT, use_flash=False,
                                          dtype=jnp.float32), (VIDEO4,),
                          lambda: vm.FinetuneVideoMAE(**W128_VMAE_FT,
                                                      dtype=torch.float32)),
        "narrator": (JaxVCLM(**W128_VCLM, use_flash=False,
                             dtype=jnp.float32),
                     (VIDEO2, jnp.zeros((1, 16), jnp.int32)),
                     lambda: VCLM(**W128_VCLM, dtype=torch.float32)),
    }


def _jax_tensor_leaves(shapes, tensor):
    """{leaf path: (flax shape, the dim JAX gives tensor)} over a tree of
    shapes, on a data x tensor mesh of the conftest's devices."""
    mesh = jax_make_mesh(data=8 // tensor, fsdp=1, tensor=tensor)
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        spec = tuple(_spec_for_param(name, leaf.shape, mesh))
        if "tensor" in spec:
            out[name] = (tuple(leaf.shape), spec.index("tensor"))
    return out


def _held(model, tensor):
    """The port's parameters held in part at ``tensor`` (rank 0 of a world
    without a process group), with their dims."""
    tensor_parallelize(model, make_mesh(data=1, tensor=tensor, world=tensor,
                                        rank=0))
    return {n: leaf.dim for n, leaf in model.tensor_layout.leaves.items()}


@pytest.mark.parametrize("tensor", [2, 4])
@pytest.mark.parametrize("family", ["clip", "cls", "vmae_pretrain",
                                    "vmae_finetune", "narrator"])
def test_held_parameters_are_jax_tensor_leaves(family, tensor):
    """Every leaf's values set to its index + 1 and carried by
    ``params_from_jax``: the port's held names are exactly those whose
    values come from a leaf JAX shards over ``tensor``, and each is cut
    along the transposed dim."""
    jm, args, build = _families_w128()[family]
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            *args))["params"]
    leaves, tree = jax.tree_util.tree_flatten_with_path(shapes)
    names = ["/".join(str(getattr(k, "key", k)) for k in p)
             for p, _ in leaves]
    marked = jax.tree_util.tree_unflatten(tree, [
        np.full(leaf.shape, i + 1, np.float32)
        for i, (_, leaf) in enumerate(leaves)])
    sd = params_from_jax(marked)
    jax_held = _jax_tensor_leaves(shapes, tensor)
    assert jax_held, family
    want = {}
    for port_name, value in sd.items():
        sources = {names[int(v) - 1] for v in torch.unique(value).tolist()}
        held = sources & set(jax_held)
        if held:
            assert held == sources, port_name
            (src,) = held
            # flax [in, out] -> the port's [out, in]
            want[port_name] = 1 - jax_held[src][1]
    model = build()
    model.load_state_dict(sd, strict=True)
    assert _held(model, tensor) == want


def _meta(name, **kw):
    with torch.device("meta"):
        return create_model(name, **kw)


FULL = {
    "CLIP_VITB16": ((jnp.zeros((1, 4, 224, 224, 3)),
                     jnp.zeros((1, 77), jnp.int32)), dict(num_frames=4)),
    "VIDEOMAE_VITB16": ((jnp.zeros((1, 16, 224, 224, 3)),
                         _mask(1568, 157)), dict(num_frames=16)),
    "VIDEOMAE_VITB16_FT": ((jnp.zeros((1, 16, 224, 224, 3)),),
                           dict(num_frames=16)),
    "VCLM_VITB16": ((jnp.zeros((1, 4, 224, 224, 3)),
                     jnp.zeros((1, 77), jnp.int32)), dict(num_frames=4)),
}


@pytest.mark.parametrize("name", sorted(FULL))
def test_held_parameters_at_full_size(name):
    """At the registry's full widths (shapes only: JAX's ``eval_shape``,
    the port on the meta device): the held parameters' whole shapes and
    dims are JAX's tensor leaves', transposed, and the leaves without a
    partner are the VCLM's cross-attention ``out_proj`` alone."""
    args, kw = FULL[name]
    jm = jax_create_model(name, use_flash_attn=False, **kw)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            *args))["params"]
    jax_held = _jax_tensor_leaves(shapes, 2)
    model = _meta(name, **kw)
    whole = {n: tuple(p.shape) for n, p in model.named_parameters()}
    held = _held(model, 2)
    want = sorted((s[::-1], 1 - d) for s, d in jax_held.values())
    assert sorted((whole[n], d) for n, d in held.items()) == want
    gathered = sorted(f"{n}.{leaf}" for n, m in model.named_modules()
                      if getattr(m, "tensor", None) is not None
                      for leaf in m.tensor.gathered)
    if name == "VCLM_VITB16":
        assert gathered == sorted(f"blocks.{i}.xattn.out_proj"
                                  for i in range(0, 12, 2))
    else:
        assert gathered == []


def test_wqkv_rows_are_the_heads_of_the_rank():
    """Rank r of t holds the q, k and v rows of heads [r H / t, (r + 1) H /
    t): the attention runs on a local [q | k | v] of H / t heads."""
    from avion_tpu_torch.models.layers import SelfAttention

    torch.manual_seed(0)
    whole = SelfAttention(256, 8)
    w = whole.Wqkv.weight.detach().clone()
    for t in (2, 4):
        for r in range(t):
            attn = SelfAttention(256, 8)
            attn.load_state_dict(whole.state_dict())
            tensor_parallelize(attn, make_mesh(data=1, tensor=t, world=t,
                                               rank=r))
            per = 256 // t
            rows = [w[part * 256 + r * per: part * 256 + (r + 1) * per]
                    for part in range(3)]
            assert torch.equal(attn.Wqkv.weight, torch.cat(rows))
            assert attn.tensor.split and attn.tensor.row_held
            assert attn.out_proj.weight.shape == (256, per)
            assert attn.Wqkv.bias.shape == (768,)  # the bias stays whole


def test_heads_that_do_not_divide_hold_jax_blocks():
    """VIDEOMAE_VITB16_H128's decoder has 3 heads of 128: at tensor=2 JAX
    shards its qkv's 1152 columns into 2 contiguous blocks.  The port
    holds those blocks (not heads), so its held set is JAX's at full size;
    the decoder's attention gathers the projection whole
    (``gather_qkv``).  Its step against JAX's:
    ``test_torch_parallel_tensor_videomae``."""
    jm = jax_create_model("VIDEOMAE_VITB16_H128", num_frames=16,
                          use_flash_attn=False)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 224, 224, 3)),
        _mask(1568, 157)))["params"]
    jax_held = _jax_tensor_leaves(shapes, 2)
    assert any(n.startswith("decoder") and "qkv" in n for n in jax_held)
    model = _meta("VIDEOMAE_VITB16_H128", num_frames=16)
    whole = {n: tuple(p.shape) for n, p in model.named_parameters()}
    held = _held(model, 2)
    want = sorted((s[::-1], 1 - d) for s, d in jax_held.values())
    assert sorted((whole[n], d) for n, d in held.items()) == want
    attn = model.decoder.resblocks[0].attn
    assert attn.tensor.gather_qkv and tuple(attn.Wqkv.weight.shape) == (
        576, 384)
    leaf = model.tensor_layout.leaves["decoder.resblocks.0.attn.Wqkv.weight"]
    for r, idx in enumerate(leaf.indices):
        assert torch.equal(idx, torch.arange(r * 576, (r + 1) * 576))
    enc = model.encoder.resblocks[0].attn  # 6 heads: cut by heads
    assert enc.tensor.split and not enc.tensor.gather_qkv


@pytest.mark.parametrize("kind,width,world,causal", [
    ("block", 256, 2, False), ("block", 256, 4, True),
    ("block", 64, 2, False), ("cross", 128, 2, False)],
    ids=["block256-t2", "block256-t4-causal", "block64-t2", "cross128-t2"])
def test_cut_module_matches_whole(kind, width, world, causal):
    """The module cut over ``world`` ranks against the whole one: output,
    input gradient and every parameter's gradient (gathered) at 1e-5.  At
    width 64 the attention's ``out_proj`` is kept whole and used in
    slices; the cross-attention's ``out_proj`` is gathered on use."""
    from avion_tpu_torch.models.layers import Block
    from avion_tpu_torch.models.narrator import CrossAttention

    torch.manual_seed(1)
    heads = width // 32
    model = (Block(width, heads, dtype=torch.float32, causal=causal)
             if kind == "block" else CrossAttention(width, heads))
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.1)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rs = np.random.RandomState(2)
    x = rs.standard_normal((2, 10, width)).astype(np.float32)
    g = rs.standard_normal((2, 10, width)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    out = model(xt) if kind == "block" else model(xt, xt)
    (out * torch.from_numpy(g)).sum().backward()
    ranks = run_ranks(workers.tensor_block, world, kind, sd, x, g, causal)
    tol = dict(atol=1e-5, rtol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(r["out"], out.detach().numpy(), **tol)
        np.testing.assert_allclose(r["dx"], xt.grad.numpy(), **tol)
        for n, p in model.named_parameters():
            np.testing.assert_allclose(r["grads"][n], p.grad.numpy(),
                                       err_msg=n, **tol)
    held = ranks[0]["held"]
    if kind == "cross":
        assert held == ["out_proj.weight"] and ranks[0]["gathered"] == [""]
    elif width == 64:
        assert held == ["attn.Wqkv.weight", "mlp.fc1.weight",
                        "mlp.fc2.weight"]
    else:
        assert held == ["attn.Wqkv.weight", "attn.out_proj.weight",
                        "mlp.fc1.weight", "mlp.fc2.weight"]


@pytest.mark.parametrize("t,causal", [(2, False), (4, True)])
def test_block_played_in_one_process_matches_whole(t, causal):
    """``run_block_local`` (the card's phase 17 plays the tensor ranks of
    a block so): output and every gradient against the whole block, f32
    on the CPU (the plain attention), at 1e-5."""
    from avion_tpu_torch.models.layers import Block
    from avion_tpu_torch.parallel.tensor_parallel import run_block_local

    torch.manual_seed(4)
    block = Block(128, 4, dtype=torch.float32, causal=causal)
    x = torch.randn(2, 9, 128, requires_grad=True)
    ref = block(x)
    g = torch.randn_like(ref)
    (ref * g).sum().backward()
    want = {n: p.grad.clone() for n, p in block.named_parameters()}
    dx = x.grad.clone()
    block.zero_grad()
    x.grad = None
    out = run_block_local(block, x, t)
    (out * g).sum().backward()
    tol = dict(atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out, ref, **tol)
    torch.testing.assert_close(x.grad, dx, **tol)
    for n, p in block.named_parameters():
        torch.testing.assert_close(p.grad, want[n], **tol, msg=n)
    with pytest.raises(ValueError, match="does not divide the 4 heads"):
        run_block_local(block, x, 3)


def test_draws_equal_on_tensor_ranks():
    """data=2 x tensor=2: a step's seed and every draw from its generator
    (patch dropout, DropPath, tube masks, mixup) agree on the tensor ranks
    of a batch group; the batch groups' seeds differ."""
    ranks = run_ranks(workers.tensor_draws, 4, 2, 2, 5, 3)
    by_group = {}
    for r in ranks:
        by_group.setdefault(r["batch"], []).append(r)
    assert sorted(by_group) == [0, 1]
    for group in by_group.values():
        assert [r["tensor"] for r in group] == [0, 1]
        a, b = group
        for key in ("seed", "kept", "drop_path", "tubes", "mixed",
                    "target"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert by_group[0][0]["seed"] != by_group[1][0]["seed"]


@pytest.mark.parametrize("fsdp", [1, 2], ids=["tensor2", "fsdp2xtensor2"])
def test_checkpoint_at_tensor_2_restores_at_world_1(fsdp, tmp_path):
    """A step at tensor=2 (with fsdp=2: FSDP2 over each rank's parts),
    then a checkpoint in the one-process layout: a world-1 state restores
    it bit for bit, parameters, moments and count."""
    from avion_tpu_torch.core.checkpoint import Checkpointer
    from avion_tpu_torch.core.config import OptimConfig
    from avion_tpu_torch.core.train_state import TrainState
    from avion_tpu_torch.optim.factory import build_optimizer

    sd = params_from_jax(_clip_tiny_params())
    out = str(tmp_path / "ckpt")
    blob, *_ = run_ranks(workers.save_after_step, 2 * fsdp, sd, OPT,
                         _batch(), out, 2)
    saved = torch.load(io.BytesIO(blob), weights_only=True)
    model = create_model("CLIP_TINY", num_frames=2)
    optimizer, _ = build_optimizer(OptimConfig(**OPT), model, workers.NITER)
    state = TrainState.create(model, optimizer)
    Checkpointer(out).restore(state)
    got = state.state_dict()
    assert state.step == 1
    for k, v in saved["model"].items():
        assert v.shape == sd[k].shape and torch.equal(got["model"][k], v), k
    ours, theirs = got["optimizer"]["adamw"], saved["optimizer"]["adamw"]
    for i, moments in theirs["state"].items():
        for name, v in moments.items():
            assert torch.equal(ours["state"][i][name], v), (i, name)
    model.load_state_dict(sd, strict=True)  # the one-process layout


@pytest.mark.parametrize("world,fsdp", [(2, 1), (4, 2)],
                         ids=["tensor2", "fsdp2xtensor2"])
def test_whole_model_gathers_the_parts(world, fsdp):
    """The eval copy (``train.common.whole_model``) of a model cut over
    ``tensor`` holds the whole weights on every rank, bit for bit."""
    sd = params_from_jax(_clip_tiny_params())
    for state, whole in run_ranks(workers.tensor_whole_model, world, sd,
                                  fsdp):
        assert whole and state.keys() == sd.keys()
        for k, v in sd.items():
            np.testing.assert_array_equal(state[k], v.numpy(), err_msg=k)


def test_checkpoint_at_world_1_restores_at_tensor_2(tmp_path):
    from avion_tpu_torch.core.checkpoint import Checkpointer
    from avion_tpu_torch.core.config import OptimConfig
    from avion_tpu_torch.core.train_state import TrainState
    from avion_tpu_torch.optim.factory import build_optimizer
    from avion_tpu_torch.parallel.sharding import make_global_batch
    from avion_tpu_torch.train.steps import make_clip_train_step

    sd = params_from_jax(_clip_tiny_params())
    model = create_model("CLIP_TINY", num_frames=2)
    model.load_state_dict(sd, strict=True)
    optimizer, _ = build_optimizer(OptimConfig(**OPT), model, workers.NITER)
    state = TrainState.create(model, optimizer)
    mesh = make_mesh(data=1)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    state, _ = make_clip_train_step(model)(state,
                                           make_global_batch(mesh, batch))
    out = str(tmp_path / "ckpt")
    Checkpointer(out).save(state.step, state)
    whole = state.state_dict()
    names = dict(zip(optimizer.names, range(len(optimizer.names))))
    for r, got in enumerate(run_ranks(workers.restore_parts, 2, sd, OPT,
                                      out, 2)):
        assert got["step"] == 1 and got["held"]
        for n, part in got["params"].items():
            layout_leaf = n in got["held"]
            want = whole["model"][n].numpy()
            mu = whole["optimizer"]["adamw"]["state"][names[n]]["exp_avg"]
            if layout_leaf:
                assert part.shape != want.shape, n
                _assert_part(part, want, n, r)
                _assert_part(got["mu"][n], mu.numpy(), n, r)
            else:
                np.testing.assert_array_equal(part, want, err_msg=n)
                np.testing.assert_array_equal(got["mu"][n], mu.numpy())


def _assert_part(part, whole, name, rank):
    """``part`` is rank ``rank``'s part of ``whole`` (of 2): its heads'
    q, k and v rows of a Wqkv, else a contiguous half along the cut dim."""
    if name.endswith("Wqkv.weight"):
        w = whole.shape[0] // 3
        rows = np.concatenate([whole[p * w + rank * w // 2:
                                     p * w + (rank + 1) * w // 2]
                               for p in range(3)])
        np.testing.assert_array_equal(part, rows, err_msg=name)
        return
    dim = next(d for d in range(part.ndim) if part.shape[d] != whole.shape[d])
    np.testing.assert_array_equal(
        part, np.split(whole, 2, axis=dim)[rank], err_msg=name)


def _clip_tiny_params():
    jm = JaxCLIP(**CLIP_TINY, use_flash=False, dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), VIDEO2,
                              jnp.zeros((1, 77), jnp.int32))["params"]
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  params)
