"""Flash attention off the fused qkv projection output, forward and backward.

Counterpart of ``avion_tpu.ops.flash_attention.flash_attention_fused_qkv``.
On CUDA tensors it runs hand-written Hopper kernels; on CPU tensors the
same functions in plain f32 PyTorch, which are also what the kernels are
checked against:

==========================  ==========================  ======================
TPU kernel (Pallas)         CUDA kernel                 plain version
==========================  ==========================  ======================
``_fwd_infer_kernel``       ``csrc/flash_fwd.cu``       ``flash_attention_fused_qkv_plain``
``_fwd_kernel`` (with lse)  ``csrc/flash_fwd.cu``       ``flash_fwd_lse_plain``
``_bwd_combined_kernel``    ``csrc/flash_bwd.cu``       ``flash_bwd_plain``
``_bwd_dq_kernel``          ``csrc/flash_bwd.cu``       ``flash_bwd_plain``
``_bwd_dkv_kernel``         ``csrc/flash_bwd.cu``       ``flash_bwd_plain``
==========================  ==========================  ======================

Without a gradient to take, :func:`flash_attention_fused_qkv` runs the
inference forward.  With one, it calls the custom op ``avion::flash_fwd_lse``
(forward that also returns the row logsumexp, in log2 units, f32
``[B, H, S]``), whose registered gradient is the custom op
``avion::flash_bwd``.  Being dispatcher ops, both are visible to a
selective-checkpoint policy (``models.layers``), which can keep the
forward's outputs instead of re-running it.  The backward writes one fused
``[B, rows, 3W]`` gradient; it takes the combined kernel while
``ceil(S, 128) <= 1024`` (the JAX package's rule) and the split dq / dkv
kernels beyond, unless :data:`_COMBINED_BWD` says otherwise.

Unlike the TPU path, S is not padded to a multiple of 128: the kernels mask
the ragged last tile themselves, so ``qkv`` may have exactly ``s`` rows.
Rows past ``s`` are never read, and get a zero gradient.
"""

from __future__ import annotations

import ctypes
import math
import threading
from collections import Counter
from typing import Optional

import torch

from avion_tpu_torch.ops import _build

SOURCE = "flash_fwd.cu"
BWD_SOURCE = "flash_bwd.cu"
LOG2E = 1.4426950408889634
HEAD_DIMS = (64, 128)
KERNELS = ("flash_fwd", "flash_fwd_lse", "flash_bwd_combined", "flash_bwd_dq",
           "flash_bwd_dkv")

# kernel launches since the last reset, by kernel name; counted only where
# a kernel is launched
launches: Counter = Counter()
# the plain versions run for CPU tensors, under the same names
plain_calls: Counter = Counter()
_count_lock = threading.Lock()

# backward route: None follows the JAX rule (combined while the padded
# sequence is at most _COMBINED_MAX_SPAD); True / False force it
_COMBINED_BWD: Optional[bool] = None
_COMBINED_MAX_SPAD = 1024


def reset_launches() -> None:
    with _count_lock:
        launches.clear()
        plain_calls.clear()


def _count(counter: Counter, name: str) -> None:
    with _count_lock:
        counter[name] += 1


def use_combined_bwd(s: int) -> bool:
    if _COMBINED_BWD is None:
        return (s + 127) // 128 * 128 <= _COMBINED_MAX_SPAD
    return bool(_COMBINED_BWD)


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "avion_flash_fwd_bf16": [_P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _I,
                             _F, _P],
    "avion_flash_bwd_combined_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                      _I, _L, _L, _L, _L, _I, _F, _F, _P],
    "avion_flash_bwd_dkv_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L,
                                 _L, _L, _L, _I, _F, _F, _P],
    "avion_flash_bwd_dq_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L,
                                _L, _L, _I, _F, _F, _P],
}


def _launch(source: str, name: str, kernel: str, *args) -> None:
    """Call ``name`` of the library built from ``source`` on the current
    stream, raise on a launch error, count a launch of ``kernel``."""
    lib = _build.library(source)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        lib.avion_cuda_error_string.argtypes = [ctypes.c_int]
        lib.avion_cuda_error_string.restype = ctypes.c_char_p
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{kernel} launch failed: "
                           + lib.avion_cuda_error_string(err).decode())
    _count(launches, kernel)


def _split(qkv: torch.Tensor, heads: int):
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be [B, S, 3*H*D], got {list(qkv.shape)}")
    w = qkv.shape[-1] // 3
    if w % heads:
        raise ValueError(f"width {w} is not divisible by {heads} heads")
    return w, w // heads


def _check_cuda(qkv: torch.Tensor, heads: int, s: int):
    """What the kernels take; returns (w, d, batch stride, row stride)."""
    w, d = _split(qkv, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16, got {qkv.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if not 0 < s <= qkv.shape[1]:
        raise ValueError(f"s={s} must be in [1, {qkv.shape[1]}]")
    bstride, rstride, cstride = qkv.stride()
    if (cstride != 1 or rstride % 8 or bstride % 8
            or qkv.data_ptr() % 16):
        raise ValueError(
            f"qkv needs unit column stride and 16-byte aligned rows, got "
            f"strides {qkv.stride()} at offset {qkv.data_ptr() % 16}")
    return w, d, bstride, rstride


def _check_dense(name: str, x: torch.Tensor, shape, dtype) -> None:
    """The backward's row-wise inputs: exactly ``shape`` and ``dtype``,
    contiguous and 16-byte aligned.  Nothing is copied to make them so."""
    if (tuple(x.shape) != tuple(shape) or x.dtype != dtype
            or x.device.type != "cuda" or not x.is_contiguous()
            or x.data_ptr() % 16):
        raise ValueError(
            f"{name} must be a contiguous, aligned {dtype} CUDA tensor of "
            f"shape {list(shape)}; got {x.dtype} {list(x.shape)} strides "
            f"{x.stride()} on {x.device}")


def _heads_first(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, S, H*D] -> [B, H, S, D] in f32."""
    b, s, w = x.shape
    return x.float().reshape(b, s, heads, w // heads).transpose(1, 2)


def _qkv_heads(qkv: torch.Tensor, heads: int, s: int):
    w, _ = _split(qkv, heads)
    return tuple(_heads_first(qkv[:, :s, i * w:(i + 1) * w], heads)
                 for i in range(3))


def _causal_mask(s: int, device) -> torch.Tensor:
    return torch.ones(s, s, dtype=torch.bool, device=device).tril()


def _scores_log2(q, k, s, causal, sm_scale):
    """Log2-domain scores (q scaled by sm_scale * log2 e), masked keys at
    -inf."""
    s2 = torch.matmul(q * (sm_scale * LOG2E), k.transpose(-1, -2))
    if causal:
        s2 = s2.masked_fill(~_causal_mask(s, q.device), -math.inf)
    return s2


def flash_fwd_lse_plain(qkv: torch.Tensor, heads: int, s: int,
                        causal: bool = False,
                        sm_scale: Optional[float] = None):
    """Plain version of the training forward, in f32, as the TPU kernel
    computes it: returns (out [B, s, W] in qkv's dtype, lse [B, H, s] f32,
    the row logsumexp of the log2-domain scores, ``m + log2(l)``)."""
    w, d = _split(qkv, heads)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    q, k, v = _qkv_heads(qkv, heads, s)
    s2 = _scores_log2(q, k, s, causal, sm_scale)
    m = s2.amax(dim=-1, keepdim=True)
    p = torch.exp2(s2 - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v) / l
    lse = (m + torch.log2(l))[..., 0]
    b = qkv.shape[0]
    return out.transpose(1, 2).reshape(b, s, w).to(qkv.dtype), lse


def flash_attention_fused_qkv_plain(qkv: torch.Tensor, heads: int, s: int, *,
                                    causal: bool = False,
                                    sm_scale: Optional[float] = None
                                    ) -> torch.Tensor:
    """Plain version of the inference forward: the training forward's
    output, [B, s, W] in qkv's dtype."""
    return flash_fwd_lse_plain(qkv, heads, s, causal, sm_scale)[0]


def flash_bwd_plain(do: torch.Tensor, qkv: torch.Tensor, out: torch.Tensor,
                    lse: torch.Tensor, heads: int, s: int,
                    causal: bool = False,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the backward, in f32: the gradient of the attention
    with respect to ``qkv`` given the output's gradient ``do`` [B, s, W],
    the forward's ``out`` and ``lse``.  Returns [B, rows, 3W] in qkv's
    dtype (dq | dk | dv), zero past row ``s``."""
    w, d = _split(qkv, heads)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    b, rows = qkv.shape[:2]
    q, k, v = _qkv_heads(qkv, heads, s)
    dof, of = _heads_first(do, heads), _heads_first(out, heads)
    p = torch.exp2(_scores_log2(q, k, s, causal, sm_scale)
                   - lse.float()[..., None])
    dp = torch.matmul(dof, v.transpose(-1, -2))
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    grads = (torch.matmul(ds, k) * sm_scale,
             torch.matmul(ds.transpose(-1, -2), q) * sm_scale,
             torch.matmul(p.transpose(-1, -2), dof))
    dqkv = qkv.new_zeros(b, rows, 3 * w)
    dqkv[:, :s] = torch.cat([g.transpose(1, 2).reshape(b, s, w)
                             for g in grads], dim=-1).to(qkv.dtype)
    return dqkv


def _fwd_cuda(qkv, heads, s, causal, sm_scale, with_lse: bool):
    w, d, bstride, rstride = _check_cuda(qkv, heads, s)
    b = qkv.shape[0]
    out = torch.empty(b, s, w, dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty(b, heads, s, dtype=torch.float32, device=qkv.device)
           if with_lse else None)
    with torch.cuda.device(qkv.device):
        _launch(SOURCE, "avion_flash_fwd_bf16",
                "flash_fwd_lse" if with_lse else "flash_fwd",
                qkv.data_ptr(), out.data_ptr(),
                lse.data_ptr() if with_lse else None, b, s, heads, d,
                bstride, rstride, out.stride(0), out.stride(1), int(causal),
                float(sm_scale * LOG2E))
    return out, lse


def _bwd_cuda(do, qkv, out, lse, heads, s, causal, sm_scale,
              route: Optional[str] = None):
    """``route``: "combined" or "split" (both split kernels); None follows
    :func:`use_combined_bwd`.  "dq" or "dkv" launch one split kernel only,
    leaving the other sections unwritten (to time each kernel)."""
    w, d, bstride, rstride = _check_cuda(qkv, heads, s)
    b, rows = qkv.shape[:2]
    # the backward reads qkv through a TMA tensor map: positive strides
    # below 2**40 bytes
    if not (0 < rstride < 2**39 and (b == 1 or 0 < bstride < 2**39)):
        raise ValueError(f"qkv strides {qkv.stride()} cannot be read by TMA")
    _check_dense("do", do, (b, s, w), torch.bfloat16)
    _check_dense("out", out, (b, s, w), torch.bfloat16)
    _check_dense("lse", lse, (b, heads, s), torch.float32)
    if route is None:
        route = "combined" if use_combined_bwd(s) else "split"
    # the kernels write every row below s; rows past it stay zero
    dqkv = (torch.empty if rows == s else torch.zeros)(
        b, rows, 3 * w, dtype=qkv.dtype, device=qkv.device)
    common = (b, s, heads, d, bstride, rstride, dqkv.stride(0),
              dqkv.stride(1), int(causal), float(sm_scale * LOG2E),
              float(sm_scale))
    # rowsum(do * out) per head, written by the combined and dkv launchers
    delta = torch.empty(b, heads, s, dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        if route == "combined":
            # per (batch, head, query tile of 64) one [64, d] share
            dq_acc = torch.zeros(b, heads, -(-s // 64) * 64, d,
                                 dtype=torch.float32, device=qkv.device)
            _launch(BWD_SOURCE, "avion_flash_bwd_combined_bf16",
                    "flash_bwd_combined", qkv.data_ptr(), do.data_ptr(),
                    out.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dq_acc.data_ptr(), dqkv.data_ptr(), *common)
            return dqkv
        if route in ("split", "dq"):
            _launch(BWD_SOURCE, "avion_flash_bwd_dq_bf16", "flash_bwd_dq",
                    qkv.data_ptr(), do.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), dqkv.data_ptr(), *common)
        if route in ("split", "dkv"):
            _launch(BWD_SOURCE, "avion_flash_bwd_dkv_bf16", "flash_bwd_dkv",
                    qkv.data_ptr(), do.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(),
                    *common)
    return dqkv


@torch.library.custom_op("avion::flash_fwd_lse", mutates_args=())
def flash_fwd_lse(qkv: torch.Tensor, heads: int, s: int, causal: bool,
                  sm_scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Training forward: (out [B, s, W], lse [B, H, s] f32, log2 units)."""
    if qkv.device.type == "cpu":
        _count(plain_calls, "flash_fwd_lse")
        return flash_fwd_lse_plain(qkv, heads, s, causal, sm_scale)
    return _fwd_cuda(qkv, heads, s, causal, sm_scale, with_lse=True)


@torch.library.custom_op("avion::flash_bwd", mutates_args=())
def flash_bwd(do: torch.Tensor, qkv: torch.Tensor, out: torch.Tensor,
              lse: torch.Tensor, heads: int, s: int, causal: bool,
              sm_scale: float) -> torch.Tensor:
    """Gradient with respect to ``qkv``: [B, rows, 3W], dq | dk | dv."""
    if qkv.device.type == "cpu":
        for name in (("flash_bwd_combined",) if use_combined_bwd(s)
                     else ("flash_bwd_dq", "flash_bwd_dkv")):
            _count(plain_calls, name)
        return flash_bwd_plain(do, qkv, out, lse, heads, s, causal, sm_scale)
    return _bwd_cuda(do, qkv, out, lse, heads, s, causal, sm_scale)


def _fwd_setup(ctx, inputs, output):
    qkv, heads, s, causal, sm_scale = inputs
    out, lse = output
    ctx.save_for_backward(qkv, out, lse)
    ctx.args = (heads, s, causal, sm_scale)
    ctx.mark_non_differentiable(lse)


def _fwd_backward(ctx, grad_out, _grad_lse):
    qkv, out, lse = ctx.saved_tensors
    return flash_bwd(grad_out, qkv, out, lse, *ctx.args), None, None, None, \
        None


flash_fwd_lse.register_autograd(_fwd_backward, setup_context=_fwd_setup)

# the op a selective-checkpoint policy keeps (models.layers)
FWD_LSE_OP = torch.ops.avion.flash_fwd_lse.default


def flash_attention_fused_qkv(qkv: torch.Tensor, heads: int, s: int, *,
                              causal: bool = False,
                              sm_scale: Optional[float] = None
                              ) -> torch.Tensor:
    """Attention straight off a fused qkv projection ``[B, S, 3*H*D]``
    (sections ``[q_all | k_all | v_all]``) over its first ``s <= S`` rows.
    Returns ``[B, s, H*D]``, differentiable with respect to ``qkv``.

    A CPU tensor takes the plain versions.  A CUDA tensor must be bf16,
    with head_dim 64 or 128, unit stride along the last axis and 16-byte
    aligned rows; anything else raises.  The kernels launch on the current
    stream."""
    _, d = _split(qkv, heads)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return flash_fwd_lse(qkv, heads, s, causal, sm_scale)[0]
    if qkv.device.type == "cpu":
        _count(plain_calls, "flash_fwd")
        return flash_attention_fused_qkv_plain(qkv, heads, s, causal=causal,
                                               sm_scale=sm_scale)
    return _fwd_cuda(qkv, heads, s, causal, sm_scale, with_lse=False)[0]
