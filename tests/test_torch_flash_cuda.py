"""The port's CUDA flash-attention kernel against its plain version, on the
card.  Skips without CUDA; run on a GPU machine (no JAX needed there) with

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


def test_backward_rejects_what_it_does_not_take(cuda):
    qkv = _qkv(1, 16, 2, 64).to(cuda, torch.bfloat16)
    out, lse = fa.flash_fwd_lse(qkv, 2, 16, False, 0.125)
    do = torch.randn(1, 16, 128, device=cuda)
    with pytest.raises(ValueError):  # f32 output gradient
        fa.flash_bwd(do, qkv, out, lse, 2, 16, False, 0.125)
    strided = torch.randn(1, 16, 256, device=cuda).bfloat16()[..., ::2]
    with pytest.raises(ValueError):  # right shape, not contiguous
        fa.flash_bwd(strided, qkv, out, lse, 2, 16, False, 0.125)
