"""QuickGELU, ``x * sigmoid(1.702 * x)``: the activation of every CLIP
tower's MLP (``avion_tpu.models.layers.quick_gelu``).

:func:`quick_gelu` calls the custom op ``avion::quick_gelu`` on a bf16, f16
or f32 tensor, whose registered gradient is the custom op
``avion::quick_gelu_bwd``; the forward saves only its input.  On a CUDA
tensor each op is one hand-written kernel (``csrc/quick_gelu.cu``): it reads
each input once, computes in f32 and writes the result once, rounded once
to the input's dtype, where the formula in PyTorch runs three kernels
forward and five backward; another dtype on CUDA is refused.  On the CPU
each op runs the formula op by op in the input's dtype, whatever it is
(:func:`quick_gelu_plain`, :func:`quick_gelu_bwd_plain`), the same bits
as autograd through ``x * torch.sigmoid(1.702 * x)``, so the parity tests
against the JAX package see what they saw before the kernels.  Meta
tensors take the fake kernels.

Being dispatcher ops, both are visible to a selective-checkpoint policy
(``models.layers._save_attn`` recomputes the forward) and to the profiler,
under their names.  :data:`launches` counts the kernels' launches and
:data:`plain_calls` the formula's calls off CUDA, by kernel name.
"""

from __future__ import annotations

import ctypes
import threading
from collections import Counter

import torch

from avion_tpu_torch.ops import _build

SOURCE = "quick_gelu.cu"
ALPHA = 1.702
# the dtypes the kernels take, by the launchers' dtype code
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

launches: Counter = Counter()
plain_calls: Counter = Counter()
_count_lock = threading.Lock()

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "avion_quick_gelu_fwd": [_P, _P, _L, _I, _P],
    "avion_quick_gelu_bwd": [_P, _P, _P, _L, _I, _P],
}


def reset_launches() -> None:
    with _count_lock:
        launches.clear()
        plain_calls.clear()


def _count(counter: Counter, name: str) -> None:
    with _count_lock:
        counter[name] += 1


def quick_gelu_plain(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(ALPHA * x)


def quick_gelu_bwd_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The gradient autograd takes through :func:`quick_gelu_plain`, node by
    node in the input's dtype: the product's two halves, the sigmoid's
    backward, the scalar product, summed."""
    s = torch.sigmoid(ALPHA * x)
    return dy * s + torch.ops.aten.sigmoid_backward(dy * x, s) * ALPHA


def _launch(name: str, kernel: str, *args) -> None:
    """Call ``name`` of the library on the current stream, raise on a launch
    error, count a launch of ``kernel``."""
    _build.call(SOURCE, name, _SIGNATURES[name], *args)
    _count(launches, kernel)


def _check_cuda(name: str, t: torch.Tensor) -> None:
    if t.dtype not in _DTYPES:
        raise ValueError(f"{name} must be f32, bf16 or f16, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@torch.library.custom_op("avion::quick_gelu", mutates_args=())
def quick_gelu_op(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(1.702 * x)`` in ``x``'s dtype: on CUDA one kernel
    (``x`` contiguous), elsewhere :func:`quick_gelu_plain`."""
    if x.device.type != "cuda":
        _count(plain_calls, "quick_gelu_fwd")
        return quick_gelu_plain(x)
    _check_cuda("x", x)
    y = torch.empty_like(x)
    if not x.numel():
        return y
    with torch.cuda.device(x.device):
        _launch("avion_quick_gelu_fwd", "quick_gelu_fwd", x.data_ptr(),
                y.data_ptr(), x.numel(), _DTYPES[x.dtype])
    return y


@quick_gelu_op.register_fake
def _quick_gelu_fake(x: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(x)


@torch.library.custom_op("avion::quick_gelu_bwd", mutates_args=())
def quick_gelu_bwd(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The gradient with respect to ``x`` of :func:`quick_gelu_op`, given
    the output's ``dy`` (the same shape and dtype): on CUDA one kernel
    (both contiguous), elsewhere :func:`quick_gelu_bwd_plain`."""
    if x.shape != dy.shape or x.dtype != dy.dtype:
        raise ValueError(f"dy {list(dy.shape)} {dy.dtype} does not match x "
                         f"{list(x.shape)} {x.dtype}")
    if x.device.type != "cuda":
        _count(plain_calls, "quick_gelu_bwd")
        return quick_gelu_bwd_plain(x, dy)
    _check_cuda("x", x)
    _check_cuda("dy", dy)
    dx = torch.empty_like(x)
    if not x.numel():
        return dx
    with torch.cuda.device(x.device):
        _launch("avion_quick_gelu_bwd", "quick_gelu_bwd", x.data_ptr(),
                dy.data_ptr(), dx.data_ptr(), x.numel(), _DTYPES[x.dtype])
    return dx


@quick_gelu_bwd.register_fake
def _quick_gelu_bwd_fake(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(x)


def _setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[0])


def _backward(ctx, dy):
    (x,) = ctx.saved_tensors
    return quick_gelu_bwd(x, dy.contiguous())


quick_gelu_op.register_autograd(_backward, setup_context=_setup)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(1.702 * x)`` through ``avion::quick_gelu``, on ``x``
    made contiguous."""
    return quick_gelu_op(x.contiguous())
