"""The port's pipelined gated decoders (``avion_tpu_torch.parallel.
pipeline_gated``) against the JAX package's (``avion_tpu.parallel.
pipeline_gated``), case for case with ``tests/test_pipeline_narrator.py``:
the VCLM (4 blocks, cross-attention every 2nd, so 2 groups; f32) with its
decoder pipelined over pp = 2 gloo ranks (``tests/torch_dist.run_ranks``)
against the JAX pipeline on a virtual mesh: logits, 1, 2 and 4
microbatches, every gradient at data=2 x pp=2 (the visual tower's too:
the visual tokens' gradient is summed over the stages), remat; the
decoder alone with the visual tokens' gradient; LaViLa's gated GPT-2
(cross position "pre"); the fallback without a mesh; the converters and
``params_from_jax`` of the group-stacked tree; cached decoding refused on
the pipelined layout; ``pp`` must divide the groups (JAX's message); and
``train_narrator.main`` over data=1 x pp=2 ranks.  Forward at 2e-5,
gradients at 5e-4."""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avion_tpu.models import narrator as jnarr
from avion_tpu.models.gpt2_gated import GatedGPT2LMHead as JaxGPT2
from avion_tpu.parallel import make_mesh as jax_make_mesh
from avion_tpu.parallel import pipeline_gated as jpg
from avion_tpu_torch.models.narrator import VCLM
from avion_tpu_torch.models.pt_import import params_from_jax
from avion_tpu_torch.parallel import pipeline_gated as ppg
from avion_tpu_torch.parallel.pipeline import run_stages_local

import torch_parallel_workers as workers
from test_torch_narrator import ego4d  # noqa: F401
from torch_dist import run_ranks

VCLM_KW = dict(vocab_size=64, context_length=12, width=32, layers=4,
               heads=2, cross_every=2, image_size=16, patch_size=8,
               num_frames=2, vision_width=32, vision_layers=2,
               vision_heads=2)
GPT2_KW = dict(vocab_size=64, max_positions=16, width=32, layers=6,
               heads=2, cross_freq=3)
FWD = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=5e-4, rtol=5e-4)


def _open(tree):
    """Gates away from 0 (so the visual tokens reach the output), the rest
    perturbed."""
    rs = np.random.RandomState(5)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: (np.full_like(v, 0.5) if any(
            k in str(p[-1]) for k in ("gate", "alpha"))
            else v + 0.02 * rs.standard_normal(v.shape).astype(v.dtype)),
        jax.device_get(tree))


@pytest.fixture(scope="module")
def vclm():
    """A JAX pipelined VCLM's params (group-stacked decoder), a batch and
    a cotangent of the logits."""
    rs = np.random.RandomState(7)
    video = rs.uniform(size=(4, 2, 16, 16, 3)).astype(np.float32)
    tokens = rs.randint(0, 64, (4, 12)).astype(np.int32)
    c = rs.standard_normal((4, 12, 64)).astype(np.float32)
    jm = jnarr.VCLM(pipeline=True, pipeline_microbatches=2, use_flash=False,
                    dtype=jnp.float32, **VCLM_KW)
    params = _open(jm.init(jax.random.PRNGKey(0), jnp.asarray(video),
                           jnp.asarray(tokens))["params"])
    return params, video, tokens, c


def _jax_vclm(params, video, tokens, c, *, m=2, pp=2, remat=False):
    mesh = jax_make_mesh(data=8 // pp, pp=pp)
    jm = jnarr.VCLM(pipeline=True, pipeline_microbatches=m, use_flash=False,
                    dtype=jnp.float32, pipeline_remat=remat, **VCLM_KW)

    def loss(p):
        logits = jm.apply({"params": p}, jnp.asarray(video),
                          jnp.asarray(tokens))
        return jnp.sum(logits * c), logits
    with jax.set_mesh(mesh):
        (_, logits), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params)
    return np.asarray(logits), {k: v.numpy() for k, v in params_from_jax(
        jax.device_get(g)).items()}


def _vclm_ranks(params, video, tokens, c, data=1, pp=2, m=2):
    return run_ranks(workers.vclm_pipe, data * pp, params_from_jax(params),
                     video, tokens, c, data, pp, m, VCLM_KW)


def test_vclm_pipeline_forward_matches_sequential(vclm):
    params, video, tokens, c = vclm
    logits, _ = _jax_vclm(params, video, tokens, c)
    for r in _vclm_ranks(params, video, tokens, c):
        np.testing.assert_allclose(r["logits"], logits, **FWD)


def _decoder(params):
    """The VCLM's decoder stack alone: JAX's ``blocks`` params, the port's
    ``blocks.{i}`` as the decoder's own names, and its visual tokens'
    width."""
    sd = params_from_jax(params)
    return {k[len("blocks."):]: v for k, v in sd.items()
            if k.startswith("blocks.")}


def _jax_decoder(stacked, x, enc, c, *, fmt="mid", m=2, pp=2, remat=False,
                 layers=4, cross_every=2):
    mesh = jax_make_mesh(data=8 // pp, pp=pp)
    kw = ({} if fmt == "mid" else dict(
        act=lambda v: jax.nn.gelu(v, approximate=True),
        cross_act=lambda v: jax.nn.relu(v) ** 2))
    dec = jpg.PipelinedGatedDecoder(
        width=32, layers=layers, heads=2, cross_every=cross_every,
        cross_position=fmt, dtype=jnp.float32, use_flash=False,
        num_microbatches=m, mesh=mesh, remat=remat, **kw)

    def loss(p, xx, ee):
        out = dec.apply({"params": p}, xx, ee)
        return jnp.sum(out * c), out
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(stacked, jnp.asarray(x),
                                                jnp.asarray(enc))
    return np.asarray(out), grads


def _decoder_inputs(batch=4, tokens=6):
    rs = np.random.RandomState(11)
    x = rs.standard_normal((batch, 12, 32)).astype(np.float32)
    enc = rs.standard_normal((batch, tokens, 32)).astype(np.float32)
    c = rs.standard_normal((batch, 12, 32)).astype(np.float32)
    return x, enc, c


@pytest.mark.parametrize("m", [1, 2, 4])
def test_vclm_pipeline_microbatch_counts(vclm, m):
    """The decoder alone at pp = 2 with ``m`` microbatches: its output, the
    visual tokens' gradient (summed over the stages) and the input's."""
    params = vclm[0]
    x, enc, c = _decoder_inputs()
    out, (_, g_x, g_enc) = _jax_decoder(params["blocks"], x, enc, c, m=m)
    for r in run_ranks(workers.pipe_stack, 2, "vclm", _decoder(params), x,
                       c, 1, 1, 2, m, False,
                       dict(width=32, layers=4, heads=2, cross_every=2),
                       enc):
        np.testing.assert_allclose(r["out"], out, **FWD)
        np.testing.assert_allclose(r["dx"], np.asarray(g_x), **GRAD)
        np.testing.assert_allclose(r["denc"], np.asarray(g_enc), **GRAD)


def test_vclm_pipeline_gradients_match_sequential(vclm):
    """The whole VCLM at data=2 x pp=2: every parameter's gradient against
    JAX's, the visual tower's included (its tokens' gradient summed over
    the stages, alike on both)."""
    params, video, tokens, c = vclm
    logits, grads = _jax_vclm(params, video, tokens, c)
    for r in _vclm_ranks(params, video, tokens, c, data=2):
        np.testing.assert_allclose(r["logits"], logits, **FWD)
        assert r["grads"].keys() == grads.keys()
        for n, g in grads.items():
            np.testing.assert_allclose(r["grads"][n], g, err_msg=n, **GRAD)


def test_vclm_pipeline_meshless_fallback(vclm):
    """Without a mesh the pipelined VCLM runs its groups in sequence: the
    logits of JAX's sequential VCLM on the unstacked params."""
    params, video, tokens, _ = vclm
    seq = jnarr.VCLM(use_flash=False, dtype=jnp.float32, **VCLM_KW)
    sp = dict(params)
    sp.update(jpg.unstack_gated_params(sp.pop("blocks"), prefix="block_"))
    ref = seq.apply({"params": sp}, jnp.asarray(video), jnp.asarray(tokens))
    pm = VCLM(**VCLM_KW, dtype=torch.float32, pipeline=True,
              pipeline_microbatches=2)
    pm.load_state_dict(params_from_jax(params), strict=True)
    got = pm(torch.from_numpy(video), torch.from_numpy(tokens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **FWD)


def _same_tree(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_gated_layout_roundtrip(vclm):
    """The port's group-stacked <-> sequential converters against JAX's, for
    the VCLM (``block_``) and GPT-2 (``h_``); ``params_from_jax`` of the
    stacked tree loads into the sequential VCLM, and the two give the same
    logits."""
    params, video, tokens, _ = vclm
    blocks = params["blocks"]
    for prefix in ("block_",):
        seq = jpg.unstack_gated_params(blocks, prefix=prefix)
        _same_tree(ppg.unstack_gated_params(blocks, prefix=prefix), seq)
        _same_tree(ppg.stack_gated_params(seq, prefix=prefix),
                   jpg.stack_gated_params(seq, prefix=prefix))
    jg = JaxGPT2(pipeline=True, pipeline_microbatches=2, dtype=jnp.float32,
                 **GPT2_KW)
    gp = jax.device_get(jg.init(jax.random.PRNGKey(1),
                                jnp.zeros((2, 5), jnp.int32),
                                jnp.zeros((2, 3, 32)))["params"])
    seq = jpg.unstack_gated_params(gp["blocks"], prefix="h_")
    _same_tree(ppg.unstack_gated_params(gp["blocks"], prefix="h_"), seq)
    _same_tree(ppg.stack_gated_params(seq, prefix="h_"),
               jpg.stack_gated_params(seq, prefix="h_"))
    sd = params_from_jax(params)
    sequential = VCLM(**VCLM_KW, dtype=torch.float32)
    sequential.load_state_dict(sd, strict=True)
    pipelined = VCLM(**VCLM_KW, dtype=torch.float32, pipeline=True)
    pipelined.load_state_dict(sd, strict=True)
    v, t = torch.from_numpy(video), torch.from_numpy(tokens)
    torch.testing.assert_close(pipelined(v, t), sequential(v, t))


def test_vclm_cached_decode_requires_sequential_layout(vclm):
    """Cached decoding refuses the pipelined decoder, with JAX's advice;
    the same state dict in the sequential VCLM decodes."""
    params, video, _, _ = vclm
    sd = params_from_jax(params)
    pm = VCLM(**VCLM_KW, dtype=torch.float32, pipeline=True)
    pm.load_state_dict(sd, strict=True)
    visual = pm.encode_video(torch.from_numpy(video))
    with pytest.raises(RuntimeError, match="sequential block layout"):
        pm.precompute_cross(visual)
    with pytest.raises(RuntimeError, match="sequential block layout"):
        pm.decode_one(torch.zeros(4, 1, dtype=torch.long), 0, None, None)
    seq = VCLM(**VCLM_KW, dtype=torch.float32)
    seq.load_state_dict(sd, strict=True)
    assert len(seq.precompute_cross(visual)) == VCLM_KW["layers"]


def test_gpt2_pipeline_forward_matches_sequential():
    """LaViLa's gated GPT-2 (6 blocks, cross-attention every 3rd: 2 groups)
    as the decoder alone at pp = 2 (cross position "pre", plain attention,
    f32 between stages): output and the visual tokens' gradient against
    JAX's."""
    jg = JaxGPT2(pipeline=True, pipeline_microbatches=2, dtype=jnp.float32,
                 **GPT2_KW)
    gp = _open(jg.init(jax.random.PRNGKey(2), jnp.zeros((2, 5), jnp.int32),
                       jnp.zeros((2, 3, 32)))["params"])
    pre = "text_decoder.transformer.h."
    sd = {k[len(pre):]: v for k, v in params_from_jax(
        {"text_decoder": gp}).items() if k.startswith(pre)}
    x, enc, c = _decoder_inputs(tokens=3)
    out, (_, g_x, g_enc) = _jax_decoder(gp["blocks"], x, enc, c, fmt="pre",
                                        layers=6, cross_every=3)
    for r in run_ranks(workers.pipe_stack, 2, "gpt2", sd, x, c, 1, 1, 2, 2,
                       False, dict(width=32, layers=6, heads=2,
                                   cross_every=3), enc):
        np.testing.assert_allclose(r["out"], out, **FWD)
        np.testing.assert_allclose(r["dx"], np.asarray(g_x), **GRAD)
        np.testing.assert_allclose(r["denc"], np.asarray(g_enc), **GRAD)
        assert r["plain_calls"] == {}  # GPT-2's attention is plain math


def test_narrator_entry_pipeline_parallel(ego4d, tmp_path):  # noqa: F811
    """``train_narrator.main`` with ``model.pipeline=true`` over 2 gloo
    ranks at ``mesh.pp=2``: both ranks train on the same batches (the same
    losses), and the checkpoint (the one-process layout, the decoder's
    stage leaves gathered) loads into the sequential VCLM."""
    from avion_tpu_torch.train.common import latest_model_state

    root, meta = ego4d
    out = str(tmp_path / "narr_pp_run")
    kw = dict(VCLM_KW, image_size=32, patch_size=16, context_length=16,
              vocab_size=49408)
    kw.pop("num_frames")
    args = ["model.name=VCLM_TINY_PP", f"data.root={root}",
            f"data.train_metadata={meta}", "data.clip_length=2",
            "data.crop_size=32", "data.batch_size=8", "data.num_workers=0",
            "optim.epochs=1", "optim.lr=1e-3", "optim.warmup_epochs=0",
            "model.pipeline=true", "model.pipeline_microbatches=2",
            "mesh.pp=2", f"output_dir={out}", "print_freq=1", "--device",
            "cpu"]
    ranks = run_ranks(workers.narrator_main, 2, kw, args, timeout=120)
    assert [r["step"] for r in ranks] == [2, 2]
    assert ranks[0]["epochs"][0]["loss"] == ranks[1]["epochs"][0]["loss"]
    assert np.isfinite(ranks[0]["epochs"][0]["loss"])
    state = latest_model_state(osp.join(out, "ckpt"))
    seq = VCLM(**kw, num_frames=2, dtype=torch.float32)
    seq.load_state_dict(state, strict=True)


def test_pp_must_divide_groups():
    """3 groups over pp = 2: the stages must split at cross-attention group
    boundaries; the port refuses with JAX's message, on the mesh and
    played."""
    from avion_tpu_torch.parallel.mesh import make_mesh
    from avion_tpu_torch.parallel.pipeline import pipeline_parallelize

    kw = dict(VCLM_KW, layers=6)
    jm = jnarr.VCLM(pipeline=True, pipeline_microbatches=2, use_flash=False,
                    dtype=jnp.float32, **kw)
    video = jnp.zeros((2, 2, 16, 16, 3))
    tokens = jnp.zeros((2, 12), jnp.int32)
    with jax.set_mesh(jax_make_mesh(data=4, pp=2)):
        with pytest.raises(AssertionError) as err:
            jm.init(jax.random.PRNGKey(0), video, tokens)
    want = "groups 3 not divisible by pp=2"
    assert want in str(err.value)
    pm = VCLM(**kw, dtype=torch.float32, pipeline=True)
    with pytest.raises(ValueError, match=want):
        pipeline_parallelize(pm, make_mesh(data=1, pp=2, world=2, rank=0))
    with pytest.raises(ValueError, match=want):
        run_stages_local(pm.blocks, torch.zeros(2, 12, 32), 2,
                         torch.zeros(2, 5, 32))


def test_vclm_pipeline_remat_matches_exact(vclm):
    """``pipeline_remat`` (each group recomputed in the backward) is a
    memory knob: the decoder's output and gradients as JAX's remat
    pipeline."""
    params = vclm[0]
    x, enc, c = _decoder_inputs()
    out, (g_p, g_x, g_enc) = _jax_decoder(params["blocks"], x, enc, c,
                                          remat=True)
    want = _decoder({**params, "blocks": jax.device_get(g_p)})
    for r in run_ranks(workers.pipe_stack, 2, "vclm", _decoder(params), x,
                       c, 1, 1, 2, 2, True,
                       dict(width=32, layers=4, heads=2, cross_every=2),
                       enc):
        np.testing.assert_allclose(r["out"], out, **FWD)
        np.testing.assert_allclose(r["denc"], np.asarray(g_enc), **GRAD)
        for n, g in want.items():
            np.testing.assert_allclose(r["grads"][n], g.numpy(), err_msg=n,
                                       **GRAD)
