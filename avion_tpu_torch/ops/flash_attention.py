"""Flash-attention forward off the fused qkv projection output.

Counterpart of ``avion_tpu.ops.flash_attention.flash_attention_fused_qkv``
on its inference path (``_fwd_fused`` with ``need_lse=False``, the Pallas
``_fwd_infer_kernel``).  On a CUDA tensor :func:`flash_attention_fused_qkv`
launches the hand-written Hopper kernel in ``csrc/flash_fwd.cu``; on a CPU
tensor it runs :func:`flash_attention_fused_qkv_plain`, the same function
in plain f32 PyTorch, which is also what the kernel is checked against.

Unlike the TPU path, S is not padded to a multiple of 128: the kernel
masks the ragged last tile itself, so ``qkv`` may have exactly ``s``
rows.  Rows past ``s`` are never read.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from avion_tpu_torch.ops import _build

SOURCE = "flash_fwd.cu"
LOG2E = 1.4426950408889634
HEAD_DIMS = (64, 128)

# kernel launches since the last reset (the only module-level state)
launches = 0
_count_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0


def _count_launch() -> None:
    global launches
    with _count_lock:
        launches += 1


def _kernel():
    lib = _build.library(SOURCE)
    fn = lib.avion_flash_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.avion_cuda_error_string.argtypes = [ctypes.c_int]
        lib.avion_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _split(qkv: torch.Tensor, heads: int):
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be [B, S, 3*H*D], got {list(qkv.shape)}")
    w = qkv.shape[-1] // 3
    if w % heads:
        raise ValueError(f"width {w} is not divisible by {heads} heads")
    return w, w // heads


def flash_attention_fused_qkv_plain(qkv: torch.Tensor, heads: int, s: int, *,
                                    causal: bool = False,
                                    sm_scale: Optional[float] = None
                                    ) -> torch.Tensor:
    """Plain PyTorch version: f32 softmax attention over the first ``s``
    rows of the q/k/v sections of ``qkv``; returns [B, s, W] in qkv's
    dtype."""
    w, d = _split(qkv, heads)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    b = qkv.shape[0]
    x = qkv[:, :s].to(torch.float32).reshape(b, s, 3, heads, d)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))  # [B, H, S, D]
    logits = torch.matmul(q, k.transpose(-1, -2)) * sm_scale
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=qkv.device).tril()
        logits = logits.masked_fill(~mask, -1e30)
    out = torch.matmul(torch.softmax(logits, dim=-1), v)
    return out.transpose(1, 2).reshape(b, s, w).to(qkv.dtype)


def flash_attention_fused_qkv(qkv: torch.Tensor, heads: int, s: int, *,
                              causal: bool = False,
                              sm_scale: Optional[float] = None
                              ) -> torch.Tensor:
    """Attention straight off a fused qkv projection ``[B, S, 3*H*D]``
    (sections ``[q_all | k_all | v_all]``) over its first ``s <= S`` rows.
    Returns ``[B, s, H*D]``.

    A CPU tensor takes the plain version.  A CUDA tensor must be bf16,
    with head_dim 64 or 128, unit stride along the last axis and 16-byte
    aligned rows; anything else raises.  The kernel launches on the
    current stream."""
    w, d = _split(qkv, heads)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if qkv.device.type == "cpu":
        return flash_attention_fused_qkv_plain(qkv, heads, s, causal=causal,
                                               sm_scale=sm_scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16, got {qkv.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    b, rows, _ = qkv.shape
    if not 0 < s <= rows:
        raise ValueError(f"s={s} must be in [1, {rows}]")
    bstride, rstride, cstride = qkv.stride()
    if (cstride != 1 or rstride % 8 or bstride % 8
            or qkv.data_ptr() % 16):
        raise ValueError(
            f"qkv needs unit column stride and 16-byte aligned rows, got "
            f"strides {qkv.stride()} at offset {qkv.data_ptr() % 16}")
    out = torch.empty(b, s, w, dtype=qkv.dtype, device=qkv.device)
    lib, fn = _kernel()
    with torch.cuda.device(qkv.device):
        err = fn(qkv.data_ptr(), out.data_ptr(), b, s, heads, d, bstride,
                 rstride, out.stride(0), out.stride(1), int(causal),
                 float(sm_scale * LOG2E),
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("flash_fwd launch failed: "
                           + lib.avion_cuda_error_string(err).decode())
    _count_launch()
    return out
