"""The port's ring attention against the JAX package's, f32 on the CPU.

- The plain hop ops (``flash_hop_fwd`` / ``flash_hop_bwd`` on CPU tensors)
  against JAX ``_fwd`` / ``_bwd`` with ``extra_bias`` 0 and -1e30, run in
  interpret mode at Pallas-legal shapes (S padded to 128): out and lse at
  2e-5, dq / dk / dv at 5e-5, nothing NaN, a voided hop's gradients 0.
- ``sequence_parallel_attention`` (``ring_flash_attention_packed`` on
  [B, S, H, D] views) over gloo groups of 2 and 4 ranks, causal and not,
  against JAX ``ring_flash_attention_packed(interpret=True)`` in
  ``shard_map`` and against attention over the whole sequence (out at
  2e-5, dq / dk / dv at 5e-5); the blockwise plain ring of
  ``tests/torch_parallel_workers.py`` against the whole sequence too.
- The sequence-parallel tiny ViT of ``tests/test_sequence_parallel.py`` at
  data=2 x sp=2 (DDP over the four ranks) against JAX's at sp=1: the
  pooled output and every parameter's gradient.

Each group runs in spawned processes with a 60 s limit
(``tests/torch_dist.py``)."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from avion_tpu.models.vit import VisionTransformer as JaxViT
from avion_tpu.ops.ring_attention import ring_flash_attention_packed
from avion_tpu.parallel import make_mesh
from avion_tpu_torch.models.pt_import import params_from_jax
from avion_tpu_torch.ops import flash_attention as fa

import torch_parallel_workers as workers
from torch_dist import run_ranks

fam = importlib.import_module("avion_tpu.ops.flash_attention")

OUT_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)
MASK = -1e30


def _packed(rs, b, s, w):
    return rs.standard_normal((b, s, w)).astype(np.float32)


def _jax_lse(lse, s):
    b, nhb, hpp, s_pad = lse.shape
    return np.asarray(lse).reshape(b, nhb * hpp, s_pad)[:, :, :s]


# only the diagonal hop is causal, and it has no bias
@pytest.mark.parametrize("causal,bias", [(False, 0.0), (False, MASK),
                                         (True, 0.0)])
@pytest.mark.parametrize("s,heads,d", [(100, 2, 64), (77, 4, 32)])
def test_plain_hop_ops_match_pallas(s, heads, d, bias, causal):
    rs = np.random.RandomState(s + heads)
    b, w, scale = 2, heads * d, d ** -0.5
    q, k, v, g = (_packed(rs, b, s, w) for _ in range(4))
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    # the hop's backward takes the global out and lse: a bias-0 forward's
    j_out0, j_lse0 = fam._fwd(jq, jk, jv, heads, scale, causal, None, True)
    j_out, j_lse = fam._fwd(jq, jk, jv, heads, scale, causal, None, True,
                            extra_bias=jnp.float32(bias))
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    fa.reset_launches()
    out, lse = fa.flash_hop_fwd(tq, tk, tv, heads, causal, scale, bias)
    assert fa.plain_calls["flash_hop_fwd"] == 1
    assert np.isfinite(out.numpy()).all() and np.isfinite(lse.numpy()).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **OUT_TOL)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(j_lse, s), **OUT_TOL)

    jd = fam._bwd(heads, scale, causal, None, True,
                  (jq, jk, jv, j_out0, j_lse0), jg,
                  extra_bias=jnp.float32(bias))
    out0 = torch.from_numpy(np.array(j_out0))
    lse0 = torch.from_numpy(_jax_lse(j_lse0, s).copy())
    got = fa.flash_hop_bwd(tg, tq, tk, tv, out0, lse0, heads, causal, scale,
                           bias).numpy()
    assert np.isfinite(got).all()
    for i, ref in enumerate(jd):
        np.testing.assert_allclose(got[..., i * w:(i + 1) * w],
                                   np.asarray(ref), err_msg="qkv"[i],
                                   **GRAD_TOL)
        if bias:
            assert not got[..., i * w:(i + 1) * w].any()


B, S, HEADS, D = 2, 64, 2, 16


@pytest.fixture(scope="module")
def ring_inputs():
    rs = np.random.RandomState(3)
    return tuple(_packed(rs, B, S, HEADS * D) for _ in range(4))


def _jax_ring(q, k, v, g, world, causal):
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("sp",))
    spec = P(None, "sp", None)

    def f(q, k, v):
        return jax.shard_map(
            functools.partial(ring_flash_attention_packed, heads=HEADS,
                              axis_name="sp", causal=causal, interpret=True),
            mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
            check_vma=False)(q, k, v)

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, vjp = jax.vjp(f, jq, jk, jv)
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(g)))]


def _whole(q, k, v, g, causal):
    """Attention over the whole sequence, f32 (the plain versions)."""
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1))
    out, lse = fa.flash_fwd_lse_plain(qkv, HEADS, S, causal)
    d = fa.flash_bwd_plain(torch.from_numpy(g), qkv, out, lse, HEADS, S,
                           causal).numpy()
    w = HEADS * D
    return [out.numpy(), d[..., :w], d[..., w:2 * w], d[..., 2 * w:]]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("world", [2, 4])
def test_ring_over_ranks_matches_jax_ring_and_whole(ring_inputs, world,
                                                    causal):
    q, k, v, g = ring_inputs
    ranks = run_ranks(workers.ring, world, q, k, v, g, HEADS, causal)
    got = [np.concatenate([r[key] for r in ranks], axis=1)
           for key in ("out", "dq", "dk", "dv")]
    # every hop ran through the hop ops: world forwards, world backwards
    for r in ranks:
        assert r["plain_calls"] == {"flash_hop_fwd": world,
                                    "flash_hop_bwd_dq": world,
                                    "flash_hop_bwd_dkv": world}
    whole = _whole(q, k, v, g, causal)
    for name, ref in (("jax ring", _jax_ring(q, k, v, g, world, causal)),
                      ("whole", whole)):
        for key, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
            np.testing.assert_allclose(
                a, b, err_msg=f"{key} vs {name}",
                **(OUT_TOL if key == "out" else GRAD_TOL))
    # the blockwise ring, differentiated through its rotations
    for key, ref in zip(("out", "dq", "dk", "dv"), whole):
        a = np.concatenate([r["blockwise"][key] for r in ranks], axis=1)
        np.testing.assert_allclose(a, ref, err_msg=f"blockwise {key}",
                                   **(OUT_TOL if key == "out" else GRAD_TOL))


@pytest.fixture(scope="module")
def vit_reference():
    """JAX's sp ViT on a 1-shard sp axis: (video, the port's state dict,
    the pooled output, the port-named gradients of sum(o cos o))."""
    rng = jax.random.PRNGKey(0)
    video = np.asarray(jax.random.normal(rng, (8, 8, 32, 32, 3),
                                         jnp.float32))
    model = JaxViT(image_size=32, patch_size=16, num_frames=8, width=32,
                   layers=2, heads=2, output_dim=None, pooling="gap",
                   dtype=jnp.float32, use_flash=False,
                   sequence_parallel=True)
    with jax.set_mesh(make_mesh(data=8, fsdp=1, tensor=1, sp=1)):
        params = jax.jit(model.init)(rng, jnp.asarray(video))["params"]

        def loss(p):
            o = model.apply({"params": p}, jnp.asarray(video))
            return jnp.sum(o * jnp.cos(o)), o

        (_, ref_out), ref_grads = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(params)

    def port_named(tree):
        return {k[len("visual."):]: v for k, v in params_from_jax(
            {"visual": jax.device_get(tree)}).items()}

    grads = {k: v.numpy() for k, v in port_named(ref_grads).items()}
    return video, port_named(params), np.asarray(ref_out), grads


@pytest.mark.parametrize("remat", [False, True])
def test_sequence_parallel_vit_matches_jax(vit_reference, remat):
    """8 clips of 8 frames x 4 patches = 32 tokens: data=2 x sp=2 (4 clips
    and 16 tokens a rank) against JAX's sp model on a 1-shard sp axis.
    Under remat the ``save_attn`` policy keeps every hop's forward: 2
    layers x 2 hops of it a rank either way."""
    video, state, ref_out, grads = vit_reference
    ranks = run_ranks(workers.vit_sp, 4, state, video, 2, 2, remat)
    for r in ranks:
        assert r["plain_calls"]["flash_hop_fwd"] == 2 * 2
        np.testing.assert_allclose(r["out"], ref_out, **OUT_TOL)
        assert r["grads"].keys() == grads.keys()
        for name, ref in grads.items():
            np.testing.assert_allclose(r["grads"][name], ref, err_msg=name,
                                       **GRAD_TOL)
