"""QuickGELU through the custom ops ``avion::quick_gelu`` and
``avion::quick_gelu_bwd`` (``avion_tpu_torch.ops.activation``).

On the CPU: the same bits as the formula and autograd through it, the ops'
registrations (``torch.library.opcheck``), and the re-run forward under the
``save_attn`` remat policy.  On the card (marked ``cuda``, skipped without
one; no JAX needed there), the kernels against the formula in f64, with

    python -m pytest --noconftest -m cuda tests/test_torch_quick_gelu.py
"""

import functools

import pytest
import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from avion_tpu_torch.models import layers
from avion_tpu_torch.ops import activation as act
from avion_tpu_torch.ops import flash_attention as fa

DTYPES = [torch.float32, torch.bfloat16, torch.float16]
# mantissa bits: one ulp of a value v is 2^(floor(log2 |v|) - bits)
MANTISSA = {torch.bfloat16: 7, torch.float16: 10}
# f32 results against the f64 formula, relative to the size of the terms
F32_REL = 1e-6
# the length of one CLIP ViT-B/16 row block at 4 frames (785 tokens of
# 3072 hidden units), and 3 over, so the vector loop leaves a scalar tail
LENGTHS = [0, 1, 7, 8, 9, 3072 * 785 + 3]


def _formula(x):
    return x * torch.sigmoid(1.702 * x)


def _inputs(n, dtype, device="cpu", seed=0):
    """x spread over the activation's bend and its tails, and a gradient."""
    g = torch.Generator().manual_seed(seed)
    x = 4 * torch.randn(n, generator=g)
    dy = torch.randn(n, generator=g)
    return x.to(device, dtype), dy.to(device, dtype)


def _autograd(x, dy, fn):
    """(fn(x), its gradient against dy)."""
    x = x.detach().requires_grad_()  # a view keeps its storage offset
    y = fn(x)
    y.backward(dy)
    return y.detach(), x.grad


@pytest.mark.parametrize("dtype", DTYPES + [torch.float64])
def test_cpu_is_the_formula_bit_for_bit(dtype):
    x, dy = _inputs(17 * 241, dtype)
    y_ref, dx_ref = _autograd(x, dy, _formula)
    act.reset_launches()
    y, dx = _autograd(x, dy, layers.quick_gelu)
    assert dict(act.plain_calls) == {"quick_gelu_fwd": 1, "quick_gelu_bwd": 1}
    assert not act.launches
    assert torch.equal(y, y_ref) and torch.equal(dx, dx_ref)
    # a strided input keeps its layout and its bits
    xt = x.view(17, 241)[:, :200].t()
    assert torch.equal(layers.quick_gelu(xt), _formula(xt))


@pytest.mark.parametrize("sample", ["f32", "f32_grad", "strided", "bf16"])
def test_opcheck(sample):
    x, dy = _inputs(35, torch.float32)
    x, dy = x.reshape(5, 7), dy.reshape(5, 7)
    if sample == "f32_grad":
        x.requires_grad_()
    elif sample == "strided":
        x, dy = x.t(), dy.t()
    elif sample == "bf16":
        x = x.to(torch.bfloat16).requires_grad_()
        dy = dy.to(torch.bfloat16)
    torch.library.opcheck(act.quick_gelu_op, (x,))
    torch.library.opcheck(act.quick_gelu_bwd, (x.detach(), dy))


def test_backward_refuses_a_mismatched_gradient():
    x, dy = _inputs(8, torch.float32)
    with pytest.raises(ValueError, match="does not match"):
        act.quick_gelu_bwd(x, dy.to(torch.bfloat16))
    with pytest.raises(ValueError, match="does not match"):
        act.quick_gelu_bwd(x, dy[:4])


def _rerun_under_remat(x):
    """The first forward's output, and the one the backward re-ran under
    ``save_attn``'s policy (the gradient of ``(quick_gelu(x) * w).sum()``
    with respect to w is that output)."""
    w = torch.ones_like(x, requires_grad=True)

    def fn(x, w):
        y = layers.quick_gelu(x)
        return y, (y * w).sum()

    context = functools.partial(create_selective_checkpoint_contexts,
                                layers._save_attn)
    y, loss = checkpoint(fn, x.detach().requires_grad_(), w,
                         use_reentrant=False, context_fn=context)
    loss.backward()
    return y.detach(), w.grad


def test_remat_reruns_the_same_forward_cpu():
    x, _ = _inputs(1000, torch.bfloat16)
    act.reset_launches()
    first, rerun = _rerun_under_remat(x)
    assert dict(act.plain_calls) == {"quick_gelu_fwd": 2, "quick_gelu_bwd": 1}
    assert torch.equal(first, rerun)


# --- on the card ---------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _f64_reference(x, dy):
    """(y, dx, the size of dx's terms) in f64 from the same inputs."""
    x, dy = x.double(), dy.double()
    s = torch.sigmoid(1.702 * x)
    lean = 1.702 * x * (1 - s)
    return x * s, dy * s * (1 + lean), dy.abs() * s * (1 + lean.abs())


def _assert_within(got, ref, size, x, what):
    """bf16 / f16: one ulp of the output's dtype, plus f32's rounding of
    the terms (``size``) that cancel where the gradient crosses zero; f32:
    F32_REL of the larger of the value and those terms.  Both also allow
    for the exponent's argument 1.702 x rounded to f32, which exp turns
    into a relative error of 2^-24 |1.702 x| (the formula in PyTorch rounds
    it too, in bf16 to the input's dtype)."""
    rel = F32_REL + 2.0 ** -24 * (1.702 * x.double()).abs()
    err = (got.double() - ref).abs()
    if got.dtype == torch.float32:
        limit = rel * torch.maximum(ref.abs(), size)
    else:
        tiny = torch.finfo(got.dtype).tiny
        ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(tiny)))
                         - MANTISSA[got.dtype])
        limit = ulp + rel * size
    worst = (err - limit).max().item() if err.numel() else 0.0
    assert worst <= 0.0, f"{what}: {worst} over the limit"


@pytest.mark.cuda
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_against_f64(cuda, dtype, n):
    x, dy = _inputs(n, dtype, cuda)
    act.reset_launches()
    y, dx = _autograd(x, dy, layers.quick_gelu)
    torch.cuda.synchronize()
    launched = {} if n == 0 else {"quick_gelu_fwd": 1, "quick_gelu_bwd": 1}
    assert dict(act.launches) == launched and not act.plain_calls
    assert y.dtype == dx.dtype == dtype and y.shape == dx.shape == (n,)
    y_ref, dx_ref, size = _f64_reference(x, dy)
    _assert_within(y, y_ref, y_ref.abs(), x, "y")
    _assert_within(dx, dx_ref, size, x, "dx")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["transposed", "misaligned"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_on_strided_and_misaligned_inputs(cuda, dtype, layout):
    x, dy = _inputs(64 * 48 + 1, dtype, cuda)
    if layout == "transposed":
        x, dy = x[1:].view(64, 48).t(), dy[1:].view(64, 48).t()
    else:  # contiguous, 2 or 4 bytes past a 16-byte boundary
        x, dy = x.view(-1)[1:], dy.view(-1)[1:]
        assert x.data_ptr() % 16 and dy.data_ptr() % 16
    act.reset_launches()
    y, dx = _autograd(x, dy, layers.quick_gelu)
    torch.cuda.synchronize()
    assert dict(act.launches) == {"quick_gelu_fwd": 1, "quick_gelu_bwd": 1}
    y_ref, dx_ref, size = _f64_reference(x, dy)
    _assert_within(y, y_ref, y_ref.abs(), x, "y")
    _assert_within(dx, dx_ref, size, x, "dx")


@pytest.mark.cuda
def test_kernels_refuse_other_dtypes(cuda):
    x, dy = _inputs(64, torch.float64, cuda)
    with pytest.raises(ValueError, match="f32, bf16 or f16"):
        layers.quick_gelu(x)
    with pytest.raises(ValueError, match="f32, bf16 or f16"):
        act.quick_gelu_bwd(x, dy)


@pytest.mark.cuda
def test_remat_reruns_the_same_forward(cuda):
    x, _ = _inputs(3072 * 197, torch.bfloat16, cuda)
    act.reset_launches()
    first, rerun = _rerun_under_remat(x)
    torch.cuda.synchronize()
    assert dict(act.launches) == {"quick_gelu_fwd": 2, "quick_gelu_bwd": 1}
    assert torch.equal(first, rerun)


def _plain_attention(qkv, heads, s, *, causal=False, sm_scale=None):
    return fa.flash_attention_fused_qkv_plain(qkv, heads, s, causal=causal,
                                              sm_scale=sm_scale)


@pytest.mark.cuda
def test_block_gradients_match_the_plain_chain(cuda, monkeypatch):
    """CLIP_VITB16's visual block (768 wide, 12 heads) in f32, attention in
    plain f32 on both sides: the kernels' parameter gradients against the
    formula's, to test_torch_layers_train.py's tolerance on each leaf over
    its largest reference value (the sum of squares over 2 x 197 tokens
    makes gradients of up to some hundreds, where 1e-6 absolute would ask
    for more than f32 holds)."""
    monkeypatch.setattr(layers, "flash_attention_fused_qkv", _plain_attention)
    torch.manual_seed(0)
    x = torch.randn(2, 197, 768, device=cuda)
    grads = []
    for fn in (layers.quick_gelu, _formula):
        torch.manual_seed(1)
        block = layers.Block(768, 12, fn, torch.float32).to(cuda)
        act.reset_launches()
        (block(x) ** 2).sum().backward()
        torch.cuda.synchronize()
        assert bool(act.launches) == (fn is layers.quick_gelu)
        grads.append([p.grad for p in block.parameters()])
    for got, ref in zip(*grads):
        top = ref.abs().max()
        torch.testing.assert_close(got / top, ref / top, rtol=1e-6, atol=1e-6)
