"""The port's CUDA flash-attention kernels against their plain versions, on
the card.  Skip without CUDA; run on a GPU machine (no JAX needed there) with

    python -m pytest --noconftest -m cuda tests/test_torch_flash_cuda.py
"""

import numpy as np
import pytest
import torch

from avion_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

BF16_TOL = 3e-2  # the JAX bf16 forward tolerance (tests/test_flash_attention.py)
# RMS error over RMS output, as in chip_smoke.py: at S in the hundreds the
# outputs are themselves ~3e-2, so the absolute bound alone is loose
REL_TOL = 5e-3


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _qkv(b, s, h, d, rows=None, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((b, rows or s, 3 * h * d)).astype(np.float32)
    return torch.from_numpy(x)


@pytest.mark.parametrize("b,s,h,d,causal", [
    (2, 1, 2, 64, False), (2, 63, 3, 64, True), (1, 64, 2, 64, False),
    (3, 65, 1, 64, True), (2, 77, 8, 64, True), (2, 200, 3, 128, False),
    (2, 130, 2, 128, True), (1, 785, 12, 64, False), (1, 785, 6, 128, False),
])
def test_kernel_matches_plain(cuda, b, s, h, d, causal):
    qkv = _qkv(b, s, h, d).to(cuda, torch.bfloat16)
    fa.reset_launches()
    out = fa.flash_attention_fused_qkv(qkv, h, s, causal=causal)
    torch.cuda.synchronize()
    assert dict(fa.launches) == {"flash_fwd": 1}
    ref = fa.flash_attention_fused_qkv_plain(qkv.float(), h, s,
                                             causal=causal)
    assert out.shape == (b, s, h * d) and out.dtype == torch.bfloat16
    diff = out.float() - ref
    err = diff.abs().max().item()
    assert err <= BF16_TOL, err
    rel = (diff.norm() / ref.norm()).item()
    assert rel <= REL_TOL, rel


def test_kernel_reads_only_the_first_s_rows(cuda):
    """Rows past ``s`` (the JAX path's padding) never reach the output."""
    b, s, h, d = 2, 100, 2, 64
    qkv = _qkv(b, s, h, d, rows=128).to(cuda, torch.bfloat16)
    qkv[:, s:] = float("nan")
    out = fa.flash_attention_fused_qkv(qkv, h, s)
    ref = fa.flash_attention_fused_qkv_plain(qkv[:, :s].contiguous(), h, s)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL


def test_kernel_rejects_what_it_does_not_take(cuda):
    qkv = _qkv(1, 16, 2, 64).to(cuda)
    with pytest.raises(TypeError):
        fa.flash_attention_fused_qkv(qkv, 2, 16)  # f32
    with pytest.raises(ValueError):
        fa.flash_attention_fused_qkv(
            _qkv(1, 16, 2, 32).to(cuda, torch.bfloat16), 2, 16)  # d=32
    wide = _qkv(1, 16, 4, 64).to(cuda, torch.bfloat16)  # last dim 768
    with pytest.raises(ValueError):
        fa.flash_attention_fused_qkv(wide[..., ::2], 2, 16)  # column stride
    with pytest.raises(ValueError):
        fa.flash_attention_fused_qkv(wide[..., 1:385], 2, 16)  # misaligned


@pytest.mark.parametrize("b,s,h,d,causal,combined", [
    (2, 1, 2, 64, False, None), (2, 63, 3, 64, True, None),
    (2, 77, 8, 64, True, None), (3, 65, 1, 64, True, False),
    (2, 200, 3, 128, False, None), (2, 130, 2, 128, True, False),
    (1, 785, 12, 64, False, None), (1, 785, 12, 64, False, False),
    (1, 785, 6, 128, False, None), (1, 1100, 2, 64, False, None),
])
def test_backward_matches_plain(cuda, b, s, h, d, causal, combined):
    """Autograd through the training forward and the backward route the
    rule (or the override) picks, against the plain f32 gradient; rows past
    ``s`` get none."""
    rows = s + 5
    qkv = _qkv(b, s, h, d, rows=rows).to(cuda, torch.bfloat16)
    do = _qkv(b, s, h, d, seed=1)[..., :h * d].to(cuda, torch.bfloat16)
    old = fa._COMBINED_BWD
    try:
        fa._COMBINED_BWD = combined
        x = qkv.clone().requires_grad_()
        fa.reset_launches()
        fa.flash_attention_fused_qkv(x, h, s, causal=causal).backward(do)
        torch.cuda.synchronize()
        route = (("flash_bwd_combined",) if fa.use_combined_bwd(s)
                 else ("flash_bwd_dq", "flash_bwd_dkv"))
    finally:
        fa._COMBINED_BWD = old
    assert dict(fa.launches) == {"flash_fwd_lse": 1, **{n: 1 for n in route}}
    y = qkv.float().requires_grad_()
    fa.flash_attention_fused_qkv_plain(y, h, s, causal=causal).backward(
        do.float())
    assert torch.count_nonzero(x.grad[:, s:]) == 0
    w = h * d
    for i in range(3):
        got = x.grad[:, :s, i * w:(i + 1) * w].float()
        ref = y.grad[:, :s, i * w:(i + 1) * w]
        diff = got - ref
        assert diff.abs().max().item() <= BF16_TOL
        if ref.norm() > 0:  # with one key dq and dk are exactly zero
            assert (diff.norm() / ref.norm()).item() <= 1.5e-2


def _backward_errors(qkv, do, h, s, causal, route):
    """The kernels' backward on ``route`` ("combined" or "split") against
    the plain f32 backward of the plain f32 forward of ``qkv[:, :s]``;
    returns the gradient and (max abs error, RMS error over RMS reference)
    per section, the ratio None where the reference is zero but for f32
    rounding (dq and dk of a single key)."""
    d = qkv.shape[-1] // 3 // h
    scale = d ** -0.5
    out, lse = fa.flash_fwd_lse(qkv, h, s, causal, scale)
    fa.reset_launches()
    got = fa._bwd_cuda(do, qkv, out, lse, h, s, causal, scale, route=route)
    torch.cuda.synchronize()
    assert dict(fa.launches) == ({"flash_bwd_combined": 1} if route == "combined"
                                 else {"flash_bwd_dq": 1, "flash_bwd_dkv": 1})
    x = qkv[:, :s].float()
    out_p, lse_p = fa.flash_fwd_lse_plain(x, h, s, causal, scale)
    ref = fa.flash_bwd_plain(do.float(), x, out_p, lse_p, h, s, causal, scale)
    w = h * d
    errs = []
    for i in range(3):
        sec = ref[..., i * w:(i + 1) * w]
        diff = got[:, :s, i * w:(i + 1) * w].float() - sec
        errs.append((diff.abs().max().item(),
                     (diff.norm() / sec.norm()).item()
                     if sec.abs().max() > 1e-4 else None))
    return got, errs


def _assert_close(errs):
    for err, rel in errs:
        assert err <= BF16_TOL, errs
        assert rel is None or rel <= 1.5e-2, errs


@pytest.mark.parametrize("route", ["combined", "split"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 200, 785, 3137])
def test_backward_tile_edges(cuda, s, d, causal, route):
    """Both routes at the edges of the 64-row tiles, against the plain f32
    backward (max abs 3e-2, RMS error over RMS reference 1.5e-2)."""
    h = 2
    qkv = _qkv(1, s, h, d, seed=s).to(cuda, torch.bfloat16)
    do = _qkv(1, s, h, d, seed=s + 1)[..., :h * d].to(cuda, torch.bfloat16)
    _assert_close(_backward_errors(qkv, do, h, s, causal, route)[1])


@pytest.mark.parametrize("route", ["combined", "split"])
def test_backward_reads_only_the_first_s_rows(cuda, route):
    """Rows past ``s`` hold NaN: the gradient is finite below ``s`` and
    zero past it (the tensor maps end at row ``s``)."""
    b, s, h, d = 2, 100, 2, 64
    qkv = _qkv(b, s, h, d, rows=160).to(cuda, torch.bfloat16)
    qkv[:, s:] = float("nan")
    do = _qkv(b, s, h, d, seed=1)[..., :h * d].to(cuda, torch.bfloat16)
    got, errs = _backward_errors(qkv, do, h, s, False, route)
    assert torch.isfinite(got[:, :s]).all()
    assert torch.count_nonzero(got[:, s:]) == 0
    _assert_close(errs)


@pytest.mark.parametrize("route", ["combined", "split"])
def test_backward_takes_a_batch_strided_view(cuda, route):
    """qkv a view whose batches lie further apart than ``rows * 3W``: the
    tensor map's batch stride, not the row count, finds each batch."""
    b, s, h, d = 3, 130, 2, 128
    big = _qkv(b, s, h, d, rows=s + 40).to(cuda, torch.bfloat16)
    qkv = big[:, :s]
    assert qkv.stride(0) > s * qkv.shape[-1]
    do = _qkv(b, s, h, d, seed=1)[..., :h * d].to(cuda, torch.bfloat16)
    _, errs = _backward_errors(qkv, do, h, s, True, route)
    _assert_close(errs)


def test_split_backward_is_bit_for_bit_repeatable(cuda):
    """The split route sums in a fixed order: two calls agree exactly."""
    b, s, h, d = 2, 785, 4, 64
    qkv = _qkv(b, s, h, d).to(cuda, torch.bfloat16)
    do = _qkv(b, s, h, d, seed=1)[..., :h * d].to(cuda, torch.bfloat16)
    out, lse = fa.flash_fwd_lse(qkv, h, s, False, d ** -0.5)
    first = fa._bwd_cuda(do, qkv, out, lse, h, s, False, d ** -0.5,
                         route="split")
    second = fa._bwd_cuda(do, qkv, out, lse, h, s, False, d ** -0.5,
                          route="split")
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_backward_rejects_what_it_does_not_take(cuda):
    qkv = _qkv(1, 16, 2, 64).to(cuda, torch.bfloat16)
    out, lse = fa.flash_fwd_lse(qkv, 2, 16, False, 0.125)
    do = torch.randn(1, 16, 128, device=cuda)
    with pytest.raises(ValueError):  # f32 output gradient
        fa.flash_bwd(do, qkv, out, lse, 2, 16, False, 0.125)
    strided = torch.randn(1, 16, 256, device=cuda).bfloat16()[..., ::2]
    with pytest.raises(ValueError):  # right shape, not contiguous
        fa.flash_bwd(strided, qkv, out, lse, 2, 16, False, 0.125)
