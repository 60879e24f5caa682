"""The port's CUDA flash-attention kernels against their plain versions, on
the card.  Skip without CUDA; run on a GPU machine (no JAX needed there) with

    python -m pytest --noconftest -m cuda tests/test_torch_flash_cuda.py
"""

import numpy as np
import pytest
import torch

from avion_tpu_torch.models.timesformer import DividedAttention
from avion_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

BF16_TOL = 3e-2  # the JAX bf16 forward tolerance (tests/test_flash_attention.py)
# RMS error over RMS output, as in chip_smoke.py: at S in the hundreds the
# outputs are themselves ~3e-2, so the absolute bound alone is loose
REL_TOL = 5e-3
# lse (log2 units) against the plain f32 forward, as in chip_smoke.py
LSE_TOL = 3e-2


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


def _forward(qkv, h, s, causal, with_lse):
    """One forward launch of the instance asked for: (out, lse or None)."""
    d = qkv.shape[-1] // 3 // h
    fa.reset_launches()
    if with_lse:
        out, lse = fa.flash_fwd_lse(qkv, h, s, causal, d ** -0.5)
    else:
        out = fa.flash_attention_fused_qkv(qkv, h, s, causal=causal)
        lse = None
    torch.cuda.synchronize()
    name = "flash_fwd_lse" if with_lse else "flash_fwd"
    assert dict(fa.launches) == {name: 1}
    return out, lse


def _assert_forward_close(qkv, h, s, causal, with_lse):
    """The instance against the plain f32 forward of ``qkv[:, :s]``: out to
    BF16_TOL and REL_TOL, lse (log2 units) to LSE_TOL."""
    out, lse = _forward(qkv, h, s, causal, with_lse)
    d = qkv.shape[-1] // 3 // h
    ref, lse_ref = fa.flash_fwd_lse_plain(qkv[:, :s].float(), h, s, causal,
                                          d ** -0.5)
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    diff = out.float() - ref
    assert diff.abs().max().item() <= BF16_TOL
    assert (diff.norm() / ref.norm()).item() <= REL_TOL
    if with_lse:
        assert lse.shape == lse_ref.shape and lse.dtype == torch.float32
        assert (lse - lse_ref).abs().max().item() <= LSE_TOL


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 200, 785, 3137])
def test_forward_tile_edges(cuda, s, d, causal, with_lse):
    """Both instances at the edges of the 64-row boxes, the 128-row blocks
    and the key tiles, against the plain f32 forward."""
    h = 2
    qkv = _qkv(2, s, h, d, seed=s).to(cuda, torch.bfloat16)
    _assert_forward_close(qkv, h, s, causal, with_lse)


@pytest.mark.parametrize("with_lse", [False, True])
def test_kernel_reads_only_the_first_s_rows(cuda, with_lse):
    """Rows past ``s`` (the JAX path's padding) hold NaN and never reach
    the output or lse (the tensor map ends at row ``s``)."""
    b, s, h, d = 2, 100, 2, 64
    qkv = _qkv(b, s, h, d, rows=128).to(cuda, torch.bfloat16)
    qkv[:, s:] = float("nan")
    out, lse = _forward(qkv, h, s, False, with_lse)
    assert torch.isfinite(out).all()
    assert lse is None or torch.isfinite(lse).all()
    _assert_forward_close(qkv, h, s, False, with_lse)


@pytest.mark.parametrize("with_lse", [False, True])
def test_forward_takes_a_batch_strided_view(cuda, with_lse):
    """qkv a view whose batches lie further apart than ``rows * 3W``: the
    tensor map's batch stride, not the row count, finds each batch."""
    b, s, h, d = 3, 130, 2, 128
    big = _qkv(b, s, h, d, rows=s + 40).to(cuda, torch.bfloat16)
    qkv = big[:, :s]
    assert qkv.stride(0) > s * qkv.shape[-1]
    _assert_forward_close(qkv, h, s, True, with_lse)


@pytest.mark.parametrize("with_lse", [False, True])
def test_forward_is_bit_for_bit_repeatable(cuda, with_lse):
    """No atomics, a fixed order of sums: two calls agree exactly."""
    b, s, h, d = 2, 785, 4, 64
    qkv = _qkv(b, s, h, d).to(cuda, torch.bfloat16)
    first = _forward(qkv, h, s, False, with_lse)
    second = _forward(qkv, h, s, False, with_lse)
    assert torch.equal(first[0], second[0])
    assert not with_lse or torch.equal(first[1], second[1])


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
    row = _qkv(1, 1, 2, 64).to(cuda, torch.bfloat16)
    with pytest.raises(ValueError):  # stride 0: no tensor map takes it
        fa.flash_attention_fused_qkv(row.expand(2, 16, 384), 2, 16)
    many = torch.zeros(fa.MAX_BATCH + 1, 1, 384, device=cuda,
                       dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="batch"):  # the grid's z
        fa.flash_attention_fused_qkv(many, 2, 1)


def test_divided_time_mode_past_the_kernels_batch(cuda):
    """TimeSformer's time mode with more grid positions than one launch
    takes (66000 sequences of 3 rows): the grouping splits them into two
    calls, forward and backward, against the f32 path."""
    b, f, n, h, d = 2, 2, 33000, 1, 64
    w = h * d
    qkv = _qkv(b, 1 + f * n, h, d).to(cuda, torch.bfloat16)
    do = _qkv(b, 1 + f * n, h, d, seed=1)[..., :w].to(cuda, torch.bfloat16)
    grouped = DividedAttention(w, h, torch.bfloat16).grouped
    plain = DividedAttention(w, h, torch.float32).plain
    y = qkv.float().requires_grad_()
    ref = plain(y, "time", f, n)
    ref.backward(do.float())
    with torch.no_grad():
        fa.reset_launches()
        out = grouped(qkv, "time", f, n)
        torch.cuda.synchronize()
    assert dict(fa.launches) == {"flash_fwd": 2}
    diff = out.float() - ref.detach()
    assert diff.abs().max().item() <= BF16_TOL
    assert (diff.norm() / ref.norm()).item() <= REL_TOL
    x = qkv.clone().requires_grad_()
    fa.reset_launches()
    grouped(x, "time", f, n).backward(do)
    torch.cuda.synchronize()
    assert dict(fa.launches) == {"flash_fwd_lse": 2, "flash_bwd_combined": 2}
    for i in range(3):
        got = x.grad[..., i * w:(i + 1) * w].float()
        want = y.grad[..., i * w:(i + 1) * w]
        diff = got - want
        # the patch rows to the kernels' tolerances; the CLS row sums the
        # gradients of all 33000 sequences a clip, so only relatively
        assert diff[:, 1:].abs().max().item() <= BF16_TOL
        assert (diff.norm() / want.norm()).item() <= 1.5e-2
        assert (diff[:, 0].norm() / want[:, 0].norm()).item() <= 1.5e-2


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


def test_backward_under_deterministic_algorithms_is_repeatable(cuda):
    """Under ``torch.use_deterministic_algorithms(True)`` a combined-route
    shape, the ViT-B/16 tower at 4 frames, takes the split kernels: two
    autograd backwards agree bit for bit and launch no combined kernel."""
    b, s, h, d = 32, 785, 12, 64
    qkv = _qkv(b, s, h, d).to(cuda, torch.bfloat16)
    do = _qkv(b, s, h, d, seed=1)[..., :h * d].to(cuda, torch.bfloat16)
    was = torch.are_deterministic_algorithms_enabled()
    grads = []
    try:
        torch.use_deterministic_algorithms(True)
        for _ in range(2):
            x = qkv.clone().requires_grad_()
            fa.reset_launches()
            fa.flash_attention_fused_qkv(x, h, s).backward(do)
            torch.cuda.synchronize()
            assert dict(fa.launches) == {"flash_fwd_lse": 1,
                                         "flash_bwd_dq": 1,
                                         "flash_bwd_dkv": 1}
            grads.append(x.grad)
    finally:
        torch.use_deterministic_algorithms(was)
    assert torch.equal(grads[0], grads[1])


def test_backward_rejects_what_it_does_not_take(cuda):
    qkv = _qkv(1, 16, 2, 64).to(cuda, torch.bfloat16)
    out, lse = fa.flash_fwd_lse(qkv, 2, 16, False, 0.125)
    do = torch.randn(1, 16, 128, device=cuda)
    with pytest.raises(ValueError):  # f32 output gradient
        fa.flash_bwd(do, qkv, out, lse, 2, 16, False, 0.125)
    strided = torch.randn(1, 16, 256, device=cuda).bfloat16()[..., ::2]
    with pytest.raises(ValueError):  # right shape, not contiguous
        fa.flash_bwd(strided, qkv, out, lse, 2, 16, False, 0.125)


BWD_REL_TOL = 1.5e-2  # dq, dk, dv: RMS error over RMS reference (chip_smoke)


@pytest.mark.parametrize("bias", [0.0, -1e30])
@pytest.mark.parametrize("b,s,h,d", [(2, 63, 3, 64), (2, 130, 2, 128),
                                     (1, 784, 12, 64)])
def test_hop_kernels_match_plain(cuda, b, s, h, d, bias):
    """A ring hop: q against k / v of another [B, S, 2W] buffer with the
    score bias; the backward on the global out and lse of a bias-0
    forward.  A voided hop (-1e30) gives finite output and lse and
    gradients of exactly 0."""
    w, scale = h * d, d ** -0.5
    q = _qkv(b, s, h, d, seed=1)[..., :w].to(cuda, torch.bfloat16)
    kv = _qkv(b, s, h, d, seed=2)[..., :2 * w].to(cuda, torch.bfloat16)
    do = _qkv(b, s, h, d, seed=3)[..., :w].to(cuda, torch.bfloat16)
    k, v = kv[..., :w], kv[..., w:]
    out, lse = fa.flash_hop_fwd(q, k, v, h, False, scale, 0.0)
    fa.reset_launches()
    o, l = fa.flash_hop_fwd(q, k, v, h, False, scale, bias)
    g = fa.flash_hop_bwd(do, q, k, v, out, lse, h, False, scale, bias)
    torch.cuda.synchronize()
    assert dict(fa.launches) == {"flash_hop_fwd": 1, "flash_hop_bwd_dq": 1,
                                 "flash_hop_bwd_dkv": 1}
    assert g.dtype == torch.float32  # the ring sums hops unrounded
    ref_o, ref_l = fa.flash_hop_fwd_plain(q.float(), k.float(), v.float(),
                                          h, s, False, scale, bias)
    assert torch.isfinite(o).all() and torch.isfinite(l).all()
    assert (o.float() - ref_o).abs().max().item() <= BF16_TOL
    assert (l - ref_l).abs().max().item() <= LSE_TOL
    if bias:
        assert not g.any()
        return
    ref = fa.flash_hop_bwd_plain(do.float(), q.float(), k.float(), v.float(),
                                 out.float(), lse, h, s, False, scale, 0.0)
    for i in range(3):
        diff = g[..., i * w:(i + 1) * w].float() - ref[..., i * w:(i + 1) * w]
        assert diff.abs().max().item() <= BF16_TOL
        assert (diff.norm() / ref[..., i * w:(i + 1) * w].norm()).item() \
            <= BWD_REL_TOL


def _block_grads(block, x, g, run):
    """(output, dx, every weight's gradient) of ``run(block, x)`` for the
    cotangent ``g``."""
    block.zero_grad(set_to_none=True)
    x = x.detach().requires_grad_()
    out = run(block, x)
    (out.float() * g).sum().backward()
    return out.detach(), x.grad, {n: p.grad.float()
                                  for n, p in block.named_parameters()}


@pytest.mark.parametrize("b,s,h,d,causal,t", [
    (2, 785, 12, 64, False, 2), (2, 785, 12, 64, False, 4),
    (1, 3137, 12, 64, False, 4), (2, 77, 8, 64, True, 2),
    (2, 77, 8, 64, True, 4), (2, 785, 6, 128, False, 2)])
def test_tensor_shards_match_whole_block(cuda, b, s, h, d, causal, t):
    """A bf16 block with its ``t`` tensor ranks played on one card
    (``parallel.tensor_parallel.run_block_local``: each rank's H / t heads
    through the kernels, the row-parallel partials summed) against the
    whole block on the same card: output within 3e-2 (the max abs error
    over the largest value) and 0.5% RMS, dx and every weight's gradient
    within 3e-2 and 1.5% RMS (chip_smoke's phase 3 bounds), and each
    shard's attention launched at H / t heads."""
    from avion_tpu_torch.models.layers import Block
    from avion_tpu_torch.parallel.tensor_parallel import run_block_local

    gen = torch.Generator(device=cuda).manual_seed(3)
    block = Block(h * d, h, causal=causal).to(cuda)
    with torch.no_grad():
        for p in block.parameters():
            if p.dim() > 1:
                p.normal_(0.0, 0.02, generator=gen)
    x = torch.randn(b, s, h * d, device=cuda, generator=gen,
                    dtype=torch.bfloat16)
    g = torch.randn(b, s, h * d, device=cuda, generator=gen)
    whole = _block_grads(block, x, g, lambda m, v: m(v))
    fa.reset_launches()
    split = _block_grads(block, x, g,
                         lambda m, v: run_block_local(m, v, t))
    assert fa.launches["flash_fwd_lse"] == t
    for got, ref, rel_tol, what in (
            (split[0], whole[0], REL_TOL, "out"),
            (split[1], whole[1], 1.5e-2, "dx"),
            *((split[2][n], whole[2][n], 1.5e-2, n) for n in whole[2])):
        # the max abs error over the largest value: the bf16 output and
        # the weights' gradients (sums over B x S rows) are not of unit
        # scale, which the kernel tests' 3e-2 assumes
        diff, ref = got.float() - ref.float(), ref.float()
        assert (diff.abs().max() / ref.abs().max()).item() <= BF16_TOL, what
        assert (diff.norm() / ref.norm()).item() <= rel_tol, what
