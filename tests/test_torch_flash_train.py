"""The port's training attention (plain path, CPU) against the JAX
package's Pallas kernels run in interpret mode, f32 throughout: the
forward with lse at 2e-5, the gradient on both backward routes at 5e-4
(the JAX f32 gradient tolerance), and the plain backward against
``_bwd_fused_combined`` on the same residuals."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avion_tpu_torch.ops import flash_attention as fa

# the module, not the function of the same name the ops package re-exports
fam = importlib.import_module("avion_tpu.ops.flash_attention")

FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-4, rtol=5e-4)
# (causal, s, heads, d): every S, head count, head dim and mask covered
CASES = [(False, 77, 2, 64), (True, 130, 3, 64), (False, 200, 2, 128),
         (True, 77, 3, 128), (False, 130, 3, 128), (True, 200, 2, 64)]


def _fused(b, s, h, d, seed):
    """[B, S_pad, 3W] with S_pad the next multiple of 128 (the JAX fused
    entry's contract); pad rows hold large finite garbage."""
    rs = np.random.RandomState(seed)
    s_pad = (s + 127) // 128 * 128
    qkv = np.full((b, s_pad, 3 * h * d), 37.5, np.float32)
    qkv[:, :s] = rs.standard_normal((b, s, 3 * h * d))
    return qkv


def _jax_lse(lse, s):
    b, nhb, hpp, s_pad = lse.shape
    return np.asarray(lse).reshape(b, nhb * hpp, s_pad)[:, :, :s]


@pytest.mark.parametrize("causal,s,heads,d", CASES)
def test_fwd_lse_matches_pallas(causal, s, heads, d):
    qkv = _fused(2, s, heads, d, seed=s + heads)
    scale = d ** -0.5
    out, lse = fa.flash_fwd_lse(torch.from_numpy(qkv), heads, s, causal,
                                scale)
    j_out, j_lse = fam._fwd_fused(jnp.asarray(qkv), heads, s, scale, causal,
                                  None, True, need_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(j_lse, s), **FWD_TOL)


def _loss_np(o):
    return (o * o.cos()).sum()


@pytest.mark.parametrize("combined", [True, False])
@pytest.mark.parametrize("causal,s,heads,d", CASES)
def test_grad_matches_pallas(causal, s, heads, d, combined):
    """Autograd through the port's custom op against ``jax.grad`` of the
    Pallas fused entry on the route the flag selects."""
    qkv = _fused(1, s, heads, d, seed=7 * s + d)
    x = torch.from_numpy(qkv).requires_grad_()
    fa.reset_launches()
    _loss_np(fa.flash_attention_fused_qkv(x, heads, s, causal=causal)) \
        .backward()
    assert fa.plain_calls["flash_fwd_lse"] == 1

    def loss(q):
        o = fam.flash_attention_fused_qkv(q, heads, s, causal=causal,
                                          interpret=True)
        return jnp.sum(o * jnp.cos(o))

    old = fam._COMBINED_BWD
    try:
        fam._COMBINED_BWD = combined
        ref = np.asarray(jax.grad(loss)(jnp.asarray(qkv)))
    finally:
        fam._COMBINED_BWD = old
    got = x.grad.numpy()
    np.testing.assert_allclose(got[:, :s], ref[:, :s], **GRAD_TOL)
    np.testing.assert_array_equal(got[:, s:], 0)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_combined_kernel(causal):
    """``flash_bwd_plain`` on the JAX forward's own residuals (out, lse)
    against ``_bwd_fused_combined``, pad rows included (zero on both)."""
    s, heads, d = 150, 2, 64
    scale = d ** -0.5
    qkv = _fused(2, s, heads, d, seed=3)
    g = np.random.RandomState(4).standard_normal(
        (2, s, heads * d)).astype(np.float32)
    out, lse = fam._fwd_fused(jnp.asarray(qkv), heads, s, scale, causal,
                              None, True, need_lse=True)
    (ref,) = fam._bwd_fused_combined(heads, s, scale, causal, None, True,
                                     (jnp.asarray(qkv), out, lse),
                                     jnp.asarray(g))
    got = fa.flash_bwd_plain(torch.from_numpy(g), torch.from_numpy(qkv),
                             torch.from_numpy(np.array(out)),
                             torch.from_numpy(_jax_lse(lse, s).copy()),
                             heads, s, causal, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD_TOL)


@pytest.mark.parametrize("s,combined,names", [
    (785, None, ("flash_bwd_combined",)),
    (1024, None, ("flash_bwd_combined",)),
    (1025, None, ("flash_bwd_dq", "flash_bwd_dkv")),
    (77, False, ("flash_bwd_dq", "flash_bwd_dkv")),
    (3137, True, ("flash_bwd_combined",)),
])
def test_backward_route_rule(s, combined, names):
    """Combined while ceil(S, 128) <= 1024 (the JAX rule), split beyond,
    unless the module override forces one."""
    old = fa._COMBINED_BWD
    try:
        fa._COMBINED_BWD = combined
        assert fa.use_combined_bwd(s) == (names == ("flash_bwd_combined",))
        if s < 1000:
            x = torch.randn(1, s, 3 * 64, requires_grad=True)
            fa.reset_launches()
            fa.flash_attention_fused_qkv(x, 1, s).sum().backward()
            assert dict(fa.plain_calls) == {"flash_fwd_lse": 1,
                                            **{n: 1 for n in names}}
    finally:
        fa._COMBINED_BWD = old


def test_inference_forward_without_grad():
    x = torch.randn(2, 77, 3 * 128)
    fa.reset_launches()
    with torch.no_grad():
        fa.flash_attention_fused_qkv(x.requires_grad_(), 2, 77, causal=True)
    fa.flash_attention_fused_qkv(x.detach(), 2, 77, causal=True)
    assert dict(fa.plain_calls) == {"flash_fwd": 2}
