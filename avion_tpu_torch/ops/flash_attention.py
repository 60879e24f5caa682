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

The kernels take q, k and v as three operands (the fused path passes
column views of ``qkv``) and an f32 ``extra_bias`` added to every
log2-domain score, as the JAX ``_fwd`` / ``_bwd`` take them.  The ring hops
of ``ops.ring_attention`` reach them through two more custom ops:
``avion::flash_hop_fwd`` (the forward with lse over local q and a
neighbour's k / v, with the hop's bias; counted as ``flash_hop_fwd``) and
``avion::flash_hop_bwd`` (dq by ``bwd_dq_kernel`` and dk / dv by
``bwd_kv_kernel``, on the global out and lse; counted as
``flash_hop_bwd_dq`` and ``flash_hop_bwd_dkv``), with their plain versions
:func:`flash_hop_fwd_plain` and :func:`flash_hop_bwd_plain`.

Without a gradient to take, :func:`flash_attention_fused_qkv` runs the
inference forward, through the custom op ``avion::flash_fwd`` (so that a
profiler links the kernel to an op, as it links the others).  With one, it
calls the custom op ``avion::flash_fwd_lse``
(forward that also returns the row logsumexp, in log2 units, f32
``[B, H, S]``), whose registered gradient is the custom op
``avion::flash_bwd``.  Being dispatcher ops, both are visible to a
selective-checkpoint policy (``models.layers``), which can keep the
forward's outputs instead of re-running it.  The backward writes one fused
``[B, rows, 3W]`` gradient; it takes the combined kernel while
``ceil(S, 128) <= 1024`` (the JAX package's rule) and the split dq / dkv
kernels beyond, unless :data:`_COMBINED_BWD` says otherwise.  Under
``torch.use_deterministic_algorithms(True)`` (``warn_only`` too) every
backward takes the split kernels: the combined kernel adds dq by bulk
reduce-adds whose order varies between runs, the split kernels sum in a
fixed order, so the same input gives the same bits.

Unlike the TPU path, S is not padded to a multiple of 128: the kernels mask
the ragged last tile themselves, so ``qkv`` may have exactly ``s`` rows.
Rows past ``s`` are never read, and get a zero gradient.

A process started with ``AVION_KERNEL_COUNTS=<dir>`` writes its counts
(``launches`` and ``plain_calls``) to ``<dir>/<pid>.json`` at exit, so a
parent can read the launches of its children
(``tools.e2e_convergence``).
"""

from __future__ import annotations

import atexit
import ctypes
import json
import math
import os
import threading
from collections import Counter
from typing import Optional

import torch

from avion_tpu_torch.ops import _build

SOURCE = "flash_fwd.cu"
BWD_SOURCE = "flash_bwd.cu"
LOG2E = 1.4426950408889634
HEAD_DIMS = (64, 128)
# the kernels put the batch on the grid's z dimension
MAX_BATCH = 65535
KERNELS = ("flash_fwd", "flash_fwd_lse", "flash_bwd_combined", "flash_bwd_dq",
           "flash_bwd_dkv", "flash_hop_fwd", "flash_hop_bwd_dq",
           "flash_hop_bwd_dkv")

# kernel launches since the last reset, by kernel name; counted only where
# a kernel is launched
launches: Counter = Counter()
# the plain versions run for CPU tensors, under the same names
plain_calls: Counter = Counter()
_count_lock = threading.Lock()

# backward route: None follows the JAX rule (combined while the padded
# sequence is at most _COMBINED_MAX_SPAD) or, under deterministic
# algorithms, the split kernels; True / False force it
_COMBINED_BWD: Optional[bool] = None
_COMBINED_MAX_SPAD = 1024


def reset_launches() -> None:
    with _count_lock:
        launches.clear()
        plain_calls.clear()


def _count(counter: Counter, name: str) -> None:
    with _count_lock:
        counter[name] += 1


def _write_counts(directory: str) -> None:
    with _count_lock:
        counts = {"launches": dict(launches),
                  "plain_calls": dict(plain_calls)}
    with open(os.path.join(directory, f"{os.getpid()}.json"), "w") as f:
        json.dump(counts, f)


if os.environ.get("AVION_KERNEL_COUNTS"):
    atexit.register(_write_counts, os.environ["AVION_KERNEL_COUNTS"])


def use_combined_bwd(s: int) -> bool:
    if _COMBINED_BWD is not None:
        return bool(_COMBINED_BWD)
    if torch.are_deterministic_algorithms_enabled():
        return False
    return (s + 127) // 128 * 128 <= _COMBINED_MAX_SPAD


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# (batch, seq, heads, head_dim), then q, k, v strides (batch, row) and the
# output's; the trailing stream pointer is appended by _launch
_SHAPE, _QKV_STRIDES = [_I] * 4, [_L] * 6
_BWD_TAIL = [*_SHAPE, *_QKV_STRIDES, _L, _L, _I, _F, _F, _F, _I, _P]
_SIGNATURES = {
    "avion_flash_fwd_bf16": [_P] * 5 + _SHAPE + _QKV_STRIDES
                            + [_L, _L, _I, _F, _F, _P],
    "avion_flash_bwd_combined_bf16": [_P] * 9 + _BWD_TAIL,
    "avion_flash_bwd_dkv_bf16": [_P] * 8 + _BWD_TAIL,
    "avion_flash_bwd_dq_bf16": [_P] * 7 + _BWD_TAIL,
}


def _launch(source: str, name: str, kernel: str, *args) -> None:
    """Call ``name`` of the library built from ``source`` on the current
    stream, raise on a launch error, count a launch of ``kernel``."""
    _build.call(source, name, _SIGNATURES[name], *args)
    _count(launches, kernel)


def _split(qkv: torch.Tensor, heads: int):
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be [B, S, 3*H*D], got {list(qkv.shape)}")
    w = qkv.shape[-1] // 3
    if w % heads:
        raise ValueError(f"width {w} is not divisible by {heads} heads")
    return w, w // heads


def _sections(qkv: torch.Tensor, heads: int):
    """The q, k and v column views of a fused ``[B, S, 3W]``."""
    w, _ = _split(qkv, heads)
    return qkv[..., :w], qkv[..., w:2 * w], qkv[..., 2 * w:]


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                heads: int, s: int):
    """What the kernels take: q, k, v [B, >= s rows, W] bf16 on one card,
    unit column stride, 16-byte aligned rows that TMA can step; returns
    (w, d, the six batch and row strides)."""
    b, _, w = q.shape
    if w % heads:
        raise ValueError(f"width {w} is not divisible by {heads} heads")
    d = w // heads
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if b > MAX_BATCH:
        raise ValueError(f"batch {b} over the kernels' {MAX_BATCH}")
    strides = []
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dim() != 3 or x.shape[0] != b or x.shape[2] != w:
            raise ValueError(f"{name} must be [{b}, S, {w}], got "
                             f"{list(x.shape)}")
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"unsupported device {x.device} for {name}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernel takes bf16, got {x.dtype}")
        if not 0 < s <= x.shape[1]:
            raise ValueError(f"s={s} must be in [1, {x.shape[1]}]")
        bstride, rstride, cstride = x.stride()
        if (cstride != 1 or rstride % 8 or bstride % 8
                or x.data_ptr() % 16):
            raise ValueError(
                f"{name} needs unit column stride and 16-byte aligned rows, "
                f"got strides {x.stride()} at offset {x.data_ptr() % 16}")
        # the kernels read each operand through a TMA tensor map: positive
        # strides below 2**40 bytes
        if not (0 < rstride < 2**39
                and (b == 1 or 0 < bstride < 2**39)):
            raise ValueError(f"{name} strides {x.stride()} cannot be read "
                             f"by TMA")
        strides += [bstride, rstride]
    return w, d, strides


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


def _causal_mask(s: int, device) -> torch.Tensor:
    return torch.ones(s, s, dtype=torch.bool, device=device).tril()


def _scores_log2(q, k, s, causal, sm_scale, bias=0.0):
    """Log2-domain scores (q scaled by sm_scale * log2 e) plus ``bias``,
    masked keys at -inf."""
    s2 = torch.matmul(q * (sm_scale * LOG2E), k.transpose(-1, -2)) + bias
    if causal:
        s2 = s2.masked_fill(~_causal_mask(s, q.device), -math.inf)
    return s2


def flash_hop_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        heads: int, s: int, causal: bool = False,
                        sm_scale: Optional[float] = None, bias: float = 0.0):
    """Plain version of the training forward over three operands
    [B, >= s, W], in f32, as the TPU kernel computes it (``_fwd`` with
    ``extra_bias``): returns (out [B, s, W] in q's dtype, lse [B, H, s]
    f32, the row logsumexp of the log2-domain scores, ``m + log2(l)``).
    With ``bias`` -1e30 every score is -1e30: out is the mean of v and lse
    about -1e30, both finite."""
    b, _, w = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(w // heads)
    qh, kh, vh = (_heads_first(x[:, :s], heads) for x in (q, k, v))
    s2 = _scores_log2(qh, kh, s, causal, sm_scale, bias)
    m = s2.amax(dim=-1, keepdim=True)
    p = torch.exp2(s2 - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, vh) / l
    lse = (m + torch.log2(l))[..., 0]
    return out.transpose(1, 2).reshape(b, s, w).to(q.dtype), lse


def flash_fwd_lse_plain(qkv: torch.Tensor, heads: int, s: int,
                        causal: bool = False,
                        sm_scale: Optional[float] = None):
    """Plain version of the training forward off the fused ``qkv``:
    (out [B, s, W], lse [B, H, s])."""
    return flash_hop_fwd_plain(*_sections(qkv, heads), heads, s, causal,
                               sm_scale)


def flash_attention_fused_qkv_plain(qkv: torch.Tensor, heads: int, s: int, *,
                                    causal: bool = False,
                                    sm_scale: Optional[float] = None
                                    ) -> torch.Tensor:
    """Plain version of the inference forward: the training forward's
    output, [B, s, W] in qkv's dtype."""
    return flash_fwd_lse_plain(qkv, heads, s, causal, sm_scale)[0]


def flash_hop_bwd_plain(do: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                        heads: int, s: int, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        bias: float = 0.0) -> torch.Tensor:
    """Plain version of the backward over three operands, in f32 (``_bwd``
    with ``extra_bias``): the gradient of the attention with respect to q,
    k and v given the output's gradient ``do`` [B, s, W], the forward's
    ``out`` and ``lse`` (a ring's global ones) and the scores' ``bias``.
    Returns [B, rows, 3W] f32 (dq | dk | dv, rows those of q), zero past
    row ``s``."""
    b, rows, w = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(w // heads)
    qh, kh, vh = (_heads_first(x[:, :s], heads) for x in (q, k, v))
    dof, of = _heads_first(do, heads), _heads_first(out, heads)
    p = torch.exp2(_scores_log2(qh, kh, s, causal, sm_scale, bias)
                   - lse.float()[..., None])
    dp = torch.matmul(dof, vh.transpose(-1, -2))
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    grads = (torch.matmul(ds, kh) * sm_scale,
             torch.matmul(ds.transpose(-1, -2), qh) * sm_scale,
             torch.matmul(p.transpose(-1, -2), dof))
    dqkv = q.new_zeros(b, rows, 3 * w, dtype=torch.float32)
    dqkv[:, :s] = torch.cat([g.transpose(1, 2).reshape(b, s, w)
                             for g in grads], dim=-1)
    return dqkv


def flash_bwd_plain(do: torch.Tensor, qkv: torch.Tensor, out: torch.Tensor,
                    lse: torch.Tensor, heads: int, s: int,
                    causal: bool = False,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the backward off the fused ``qkv``: [B, rows, 3W]
    (dq | dk | dv) in qkv's dtype, zero past row ``s``."""
    return flash_hop_bwd_plain(do, *_sections(qkv, heads), out, lse, heads,
                               s, causal, sm_scale).to(qkv.dtype)


def _fwd_launch(q, k, v, heads, s, causal, sm_scale, with_lse: bool,
                bias: float = 0.0, kernel: Optional[str] = None):
    """The forward kernel over q, k, v; ``kernel`` names the launch in
    :data:`launches` (default ``flash_fwd_lse`` or ``flash_fwd``)."""
    w, d, strides = _check_cuda(q, k, v, heads, s)
    b = q.shape[0]
    out = torch.empty(b, s, w, dtype=q.dtype, device=q.device)
    lse = (torch.empty(b, heads, s, dtype=torch.float32, device=q.device)
           if with_lse else None)
    kernel = kernel or ("flash_fwd_lse" if with_lse else "flash_fwd")
    with torch.cuda.device(q.device):
        _launch(SOURCE, "avion_flash_fwd_bf16", kernel, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if with_lse else None, b, s, heads, d,
                *strides, out.stride(0), out.stride(1), int(causal),
                float(sm_scale * LOG2E), float(bias))
    return out, lse


def _bwd_launch(do, q, k, v, out, lse, heads, s, causal, sm_scale,
                route: Optional[str] = None, bias: float = 0.0,
                prefix: str = "flash_bwd", out_f32: bool = False):
    """``route``: "combined" or "split" (both split kernels); None follows
    :func:`use_combined_bwd`.  "dq" or "dkv" launch one split kernel only,
    leaving the other sections unwritten (to time each kernel).  Launches
    count as ``<prefix>_combined``, ``<prefix>_dq`` and ``<prefix>_dkv``.
    Returns [B, rows of q, 3W] (dq | dk | dv), in q's dtype or, with
    ``out_f32`` (split kernels only), in f32."""
    w, d, strides = _check_cuda(q, k, v, heads, s)
    b, rows = q.shape[:2]
    _check_dense("do", do, (b, s, w), torch.bfloat16)
    _check_dense("out", out, (b, s, w), torch.bfloat16)
    _check_dense("lse", lse, (b, heads, s), torch.float32)
    if route is None:
        route = "combined" if use_combined_bwd(s) else "split"
    if out_f32 and route == "combined":
        raise ValueError("the combined backward writes bf16 only")
    # the kernels write every row below s; rows past it stay zero
    dqkv = (torch.empty if rows == s else torch.zeros)(
        b, rows, 3 * w, dtype=torch.float32 if out_f32 else q.dtype,
        device=q.device)
    common = (b, s, heads, d, *strides, dqkv.stride(0), dqkv.stride(1),
              int(causal), float(sm_scale * LOG2E), float(sm_scale),
              float(bias), int(out_f32))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            out.data_ptr(), lse.data_ptr())
    # rowsum(do * out) per head, written by the combined and dkv launchers
    delta = torch.empty(b, heads, s, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        if route == "combined":
            # per (batch, head, query tile of 64) one [64, d] share
            dq_acc = torch.zeros(b, heads, -(-s // 64) * 64, d,
                                 dtype=torch.float32, device=q.device)
            _launch(BWD_SOURCE, "avion_flash_bwd_combined_bf16",
                    f"{prefix}_combined", *ptrs, delta.data_ptr(),
                    dq_acc.data_ptr(), dqkv.data_ptr(), *common)
            return dqkv
        if route in ("split", "dq"):
            _launch(BWD_SOURCE, "avion_flash_bwd_dq_bf16", f"{prefix}_dq",
                    *ptrs, dqkv.data_ptr(), *common)
        if route in ("split", "dkv"):
            _launch(BWD_SOURCE, "avion_flash_bwd_dkv_bf16", f"{prefix}_dkv",
                    *ptrs, delta.data_ptr(), dqkv.data_ptr(), *common)
    return dqkv


def _fwd_cuda(qkv, heads, s, causal, sm_scale, with_lse: bool):
    """The forward kernel off a fused ``qkv`` (its three column views)."""
    return _fwd_launch(*_sections(qkv, heads), heads, s, causal, sm_scale,
                       with_lse)


def _bwd_cuda(do, qkv, out, lse, heads, s, causal, sm_scale,
              route: Optional[str] = None):
    """The backward kernels off a fused ``qkv``: [B, rows, 3W]."""
    return _bwd_launch(do, *_sections(qkv, heads), out, lse, heads, s,
                       causal, sm_scale, route)


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


@torch.library.custom_op("avion::flash_fwd", mutates_args=())
def flash_fwd(qkv: torch.Tensor, heads: int, s: int, causal: bool,
              sm_scale: float) -> torch.Tensor:
    """Inference forward: out [B, s, W]."""
    if qkv.device.type == "cpu":
        _count(plain_calls, "flash_fwd")
        return flash_attention_fused_qkv_plain(qkv, heads, s, causal=causal,
                                               sm_scale=sm_scale)
    return _fwd_cuda(qkv, heads, s, causal, sm_scale, with_lse=False)[0]


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
    return flash_fwd(qkv, heads, s, causal, sm_scale)


@torch.library.custom_op("avion::flash_hop_fwd", mutates_args=())
def flash_hop_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  heads: int, causal: bool, sm_scale: float,
                  bias: float) -> tuple[torch.Tensor, torch.Tensor]:
    """One ring hop's forward: local ``q`` against ``k`` / ``v`` (views of
    a neighbour's [B, S, 2W] buffer), every score plus ``bias``; returns
    (out [B, S, W], lse [B, H, S] f32, log2 units)."""
    s = q.shape[1]
    if q.device.type == "cpu":
        _count(plain_calls, "flash_hop_fwd")
        return flash_hop_fwd_plain(q, k, v, heads, s, causal, sm_scale, bias)
    return _fwd_launch(q, k, v, heads, s, causal, sm_scale, with_lse=True,
                       bias=bias, kernel="flash_hop_fwd")


@torch.library.custom_op("avion::flash_hop_bwd", mutates_args=())
def flash_hop_bwd(do: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                  heads: int, causal: bool, sm_scale: float,
                  bias: float) -> torch.Tensor:
    """One ring hop's backward on the global ``out`` and ``lse``: dq by the
    dq kernel, dk / dv by the dkv kernel; [B, S, 3W] (dq | dk | dv) in f32,
    so that the ring sums its hops without rounding each to bf16."""
    s = q.shape[1]
    if q.device.type == "cpu":
        _count(plain_calls, "flash_hop_bwd_dq")
        _count(plain_calls, "flash_hop_bwd_dkv")
        return flash_hop_bwd_plain(do, q, k, v, out, lse, heads, s, causal,
                                   sm_scale, bias)
    return _bwd_launch(do, q, k, v, out, lse, heads, s, causal, sm_scale,
                       route="split", bias=bias, prefix="flash_hop_bwd",
                       out_f32=True)


# and under sequence parallelism each ring hop's forward (models.layers)
HOP_FWD_OP = torch.ops.avion.flash_hop_fwd.default
