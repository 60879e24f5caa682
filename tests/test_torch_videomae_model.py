"""The port's VideoMAE modules on the CPU against the JAX package's: both
models on weights carried by ``params_from_jax`` and the same numpy inputs
(f32 to 2e-5, bf16 to 3e-2), the mask split, DropPath under remat, the
registry's geometry, and ``import_videomae_pt`` (fused and split q / v
bias layouts; a pretraining-layout file raises)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avion_tpu.data.transforms import tube_mask_batch
from avion_tpu.models import videomae as jvm
from avion_tpu.models.pt_import import import_videomae_pt as jax_import
from avion_tpu_torch.models import videomae as vm
from avion_tpu_torch.models.pt_import import import_videomae_pt, params_from_jax
from avion_tpu_torch.models.registry import create_model

GEOMETRY = dict(image_size=32, patch_size=16, num_frames=4, tubelet_size=2)
PRETRAIN = dict(GEOMETRY, encoder_width=64, encoder_layers=2,
                encoder_heads=2, decoder_width=32, decoder_layers=2,
                decoder_heads=2, mask_ratio=0.5)
FINETUNE = dict(GEOMETRY, width=64, layers=2, heads=2, num_classes=5)
TOLS = {"f32": dict(atol=2e-5, rtol=2e-5), "bf16": dict(atol=3e-2, rtol=3e-2)}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed=0, batch=3):
    rs = np.random.RandomState(seed)
    video = rs.randn(batch, 4, 32, 32, 3).astype(np.float32)
    return video, tube_mask_batch(rs, batch, 2, 2, 2, 0.5)


def pretrain_pair(dtype="f32", seed=0, **kw):
    """(JAX module, its params, the port's module with them)."""
    jd, td = DTYPES[dtype]
    jm = jvm.PretrainVideoMAE(**PRETRAIN, use_flash=False, dtype=jd, **kw)
    video, mask = _inputs()
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(video),
                     jnp.asarray(mask))["params"]
    pm = vm.PretrainVideoMAE(**PRETRAIN, dtype=td, **kw)
    pm.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    return jm, params, pm


def finetune_pair(dtype="f32", seed=1, **kw):
    jd, td = DTYPES[dtype]
    jm = jvm.FinetuneVideoMAE(**FINETUNE, use_flash=False, dtype=jd, **kw)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.asarray(_inputs()[0]))["params"]
    pm = vm.FinetuneVideoMAE(**FINETUNE, dtype=td, **kw)
    pm.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    return jm, params, pm


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pretrain_forward_matches_jax(dtype):
    jm, params, pm = pretrain_pair(dtype)
    video, mask = _inputs(seed=5)
    jpred, jidx = jm.apply({"params": params}, jnp.asarray(video),
                           jnp.asarray(mask))
    with torch.no_grad():
        pred, idx = pm(torch.from_numpy(video), torch.from_numpy(mask))
    assert pred.dtype == torch.float32 and pred.shape == jpred.shape
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred, np.float32),
                               **TOLS[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_finetune_forward_matches_jax(dtype):
    jm, params, pm = finetune_pair(dtype)
    video = _inputs(seed=6)[0]
    jlogits = jm.apply({"params": params}, jnp.asarray(video))
    with torch.no_grad():
        logits = pm(torch.from_numpy(video))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(jlogits, np.float32), **TOLS[dtype])


def test_tables_are_buffers_not_parameters():
    _, params, pm = pretrain_pair()
    names = {n for n, _ in pm.named_parameters()}
    assert not any("pos_embed" in n for n in names)
    assert set(pm.state_dict()) == names
    assert len(names) == len(jax.tree_util.tree_leaves(params))
    np.testing.assert_array_equal(pm.pos_embed.numpy(),
                                  jvm.sincos_pos_embed(8, 64))


def test_split_mask_indices_and_patchify_match_jax():
    video, mask = _inputs(batch=4)
    vis, msk = vm.split_mask_indices(torch.from_numpy(mask), 8)
    jvis, jmsk = jvm.split_mask_indices(jnp.asarray(mask), 8)
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
    np.testing.assert_array_equal(msk.numpy(), np.asarray(jmsk))
    np.testing.assert_array_equal(
        vm.tube_patchify(torch.from_numpy(video), 16, 2).numpy(),
        np.asarray(jvm.tube_patchify(jnp.asarray(video), 16, 2)))


def test_init_weights_fills_the_tables_after_meta_build():
    with torch.device("meta"):
        m = create_model("VIDEOMAE_TINY")
    m = m.to_empty(device="cpu").init_weights(torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(m.decoder_pos_embed.numpy(),
                                  jvm.sincos_pos_embed(8, 32))
    assert m.encoder_to_decoder.bias is None
    assert abs(m.mask_token.std().item() - 0.02) < 0.01


@pytest.mark.parametrize("name,n_visible,heads", [
    ("VIDEOMAE_VITB16", 160, (12, 6)), ("VIDEOMAE_VITB16_H128", 160, (6, 3))])
def test_registry_geometry(name, n_visible, heads):
    with torch.device("meta"):
        m = create_model(name, use_grad_checkpointing=True, decoder_depth=4)
    assert m.num_patches == 1568 and m.n_visible == n_visible
    assert m.patch_dim == 1536 and m.dtype == torch.bfloat16
    assert (m.encoder.resblocks[0].attn.heads,
            m.decoder.resblocks[0].attn.heads) == heads
    assert m.encoder.remat and len(m.decoder.resblocks) == 4
    with torch.device("meta"):
        ft = create_model("VIDEOMAE_VITB16_FT", num_classes=7)
    assert ft.head.out_features == 7 and ft.encoder.drop_rates[-1] == 0.1


def test_drop_path_schedule_and_remat():
    """The depth schedule is JAX's, and gradients with remat equal those
    without under the same generator seed (the masks are drawn before the
    blocks)."""
    def grads(remat):
        torch.manual_seed(0)
        m = vm.FinetuneVideoMAE(**FINETUNE, drop_path_rate=0.5,
                                dtype=torch.float32, remat=remat)
        video = torch.from_numpy(_inputs(seed=2, batch=8)[0])
        out = m(video, deterministic=False,
                generator=torch.Generator().manual_seed(3))
        out.square().sum().backward()
        return m.encoder.drop_rates, [p.grad for p in m.parameters()]

    rates, plain = grads(False)
    assert rates == [0.0, 0.5]
    _, remat = grads(True)
    for a, b in zip(plain, remat):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    keep = vm.FinetuneVideoMAE(**FINETUNE, drop_path_rate=0.5).encoder \
        .draw_drop_path(4096, torch.Generator().manual_seed(0), "cpu")
    assert keep.shape == (2, 2, 4096) and keep[0].all()
    assert abs(keep[1].float().mean().item() - 0.5) < 0.03


def _reference_state(seed=0, fused=False, width=64, layers=2):
    """A reference finetune-layout state dict (numpy): split q / v bias
    unless ``fused``."""
    rs = np.random.RandomState(seed)

    def r(*shape):
        return rs.randn(*shape).astype(np.float32)

    sd = {"patch_embed.proj.weight": r(width, 3, 2, 16, 16),
          "patch_embed.proj.bias": r(width), "fc_norm.weight": r(width),
          "fc_norm.bias": r(width), "head.weight": r(5, width),
          "head.bias": r(5)}
    for i in range(layers):
        p = f"blocks.{i}."
        for n in ("norm1", "norm2"):
            sd[p + n + ".weight"], sd[p + n + ".bias"] = r(width), r(width)
        if fused:
            sd[p + "attn.Wqkv.weight"] = r(3 * width, width)
            sd[p + "attn.Wqkv.bias"] = r(3 * width)
        else:
            sd[p + "attn.qkv.weight"] = r(3 * width, width)
            sd[p + "attn.q_bias"], sd[p + "attn.v_bias"] = r(width), r(width)
        sd[p + "attn.proj.weight"], sd[p + "attn.proj.bias"] = \
            r(width, width), r(width)
        sd[p + "mlp.fc1.weight"], sd[p + "mlp.fc1.bias"] = \
            r(4 * width, width), r(4 * width)
        sd[p + "mlp.fc2.weight"], sd[p + "mlp.fc2.bias"] = \
            r(width, 4 * width), r(width)
    return sd


@pytest.mark.parametrize("fused", [False, True], ids=["qv_bias", "wqkv"])
def test_import_videomae_pt_matches_jax(fused, tmp_path):
    sd = _reference_state(fused=fused)
    path = str(tmp_path / "ft.pt")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               path)
    got = import_videomae_pt(path)
    want = params_from_jax(jax_import(path))
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    if not fused:
        b = got["encoder.resblocks.1.attn.Wqkv.bias"]
        assert torch.count_nonzero(b[64:128]) == 0
    # the imported weights give JAX's logits
    jm = jvm.FinetuneVideoMAE(**FINETUNE, use_flash=False, dtype=jnp.float32)
    pm = vm.FinetuneVideoMAE(**FINETUNE, dtype=torch.float32)
    pm.load_state_dict(got, strict=True)
    video = _inputs(seed=4)[0]
    jl = jm.apply({"params": jax_import(path)}, jnp.asarray(video))
    with torch.no_grad():
        np.testing.assert_allclose(pm(torch.from_numpy(video)).numpy(),
                                   np.asarray(jl), **TOLS["f32"])


def test_import_videomae_pt_raises_on_the_pretraining_layout(tmp_path):
    sd = {"encoder." + k.replace("fc_norm", "norm"): torch.from_numpy(v)
          for k, v in _reference_state().items() if not k.startswith("head")}
    path = str(tmp_path / "pretrain.pt")
    torch.save(sd, path)
    assert jax_import(path).keys() <= {"patch_embed", "fc_norm"}  # the gap
    with pytest.raises(ValueError, match="pretraining layout"):
        import_videomae_pt(path)
