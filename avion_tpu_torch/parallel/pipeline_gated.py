"""GPipe pipeline for the gated cross-attention decoders
(``avion_tpu.parallel.pipeline_gated``).

The narrator decoders are not a stack of one repeated block: every
``cross_every``-th block carries a gated cross-attention sub-block over
the visual tokens.  At the group level they are uniform: ``G = layers /
cross_every`` groups of ``[cross-block, plain, ..., plain]``, so the
pipeline's units are groups and its stages split at group boundaries
(``pp`` must divide ``G``).  Every stage reads the visual tokens of the
microbatch it holds at that tick, so their gradient is summed over ``pp``.

- ``cross_position="mid"``: the VCLM's ``models.narrator.
  GatedDecoderBlock`` (self-attention, gated cross, MLP; the flash kernels
  in its self-attention).
- ``cross_position="pre"``: LaViLa's ``models.gpt2_gated.GatedGPT2Block``
  (gated cross before the GPT-2 block; plain attention, as in JAX).  Its
  residual stream is f32 after a gated cross sub-block (the gate is an f32
  scalar), so the activations between stages are f32.

:class:`PipelinedGatedDecoder` is a ``ModuleList`` of the port's blocks, so
a decoder keeps its sequential names (``blocks.{i}``, ``transformer.h.{i}``)
and checkpoints load both ways; :func:`stack_gated_params` /
:func:`unstack_gated_params` convert the JAX package's group-stacked tree
(``params_from_jax`` uses them).  ``remat`` checkpoints each group (its
backward recomputes the group's blocks, JAX's ``pipeline_remat``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from avion_tpu_torch.parallel.pipeline import _get, _put, run_pipelined

_SELF_PATHS: Dict[str, Dict[str, tuple]] = {
    "vclm": {
        "ln1_scale": ("ln_1", "norm", "scale"),
        "ln1_bias": ("ln_1", "norm", "bias"),
        "qkv_kernel": ("attn", "qkv", "kernel"),
        "qkv_bias": ("attn", "qkv", "bias"),
        "out_kernel": ("attn", "out_proj", "kernel"),
        "out_bias": ("attn", "out_proj", "bias"),
        "ln2_scale": ("ln_2", "norm", "scale"),
        "ln2_bias": ("ln_2", "norm", "bias"),
        "fc1_kernel": ("mlp", "fc1", "kernel"),
        "fc1_bias": ("mlp", "fc1", "bias"),
        "fc2_kernel": ("mlp", "fc2", "kernel"),
        "fc2_bias": ("mlp", "fc2", "bias"),
    },
    "gpt2": {
        "ln1_scale": ("ln_1", "scale"),
        "ln1_bias": ("ln_1", "bias"),
        "qkv_kernel": ("attn", "c_attn", "kernel"),
        "qkv_bias": ("attn", "c_attn", "bias"),
        "out_kernel": ("attn", "c_proj", "kernel"),
        "out_bias": ("attn", "c_proj", "bias"),
        "ln2_scale": ("ln_2", "scale"),
        "ln2_bias": ("ln_2", "bias"),
        "fc1_kernel": ("mlp", "c_fc", "kernel"),
        "fc1_bias": ("mlp", "c_fc", "bias"),
        "fc2_kernel": ("mlp", "c_proj", "kernel"),
        "fc2_bias": ("mlp", "c_proj", "bias"),
    },
}

_CROSS_PATHS: Dict[str, Dict[str, tuple]] = {
    "vclm": {
        "gate_attn": ("attn_gate",),
        "lnx_scale": ("ln_x", "norm", "scale"),
        "lnx_bias": ("ln_x", "norm", "bias"),
        "xattn_q_kernel": ("xattn", "q", "kernel"),
        "xattn_q_bias": ("xattn", "q", "bias"),
        "xattn_kv_kernel": ("xattn", "kv", "kernel"),
        "xattn_kv_bias": ("xattn", "kv", "bias"),
        "xattn_out_kernel": ("xattn", "out_proj", "kernel"),
        "xattn_out_bias": ("xattn", "out_proj", "bias"),
        "gate_mlp": ("mlp_gate",),
        "lnxm_scale": ("ln_xm", "norm", "scale"),
        "lnxm_bias": ("ln_xm", "norm", "bias"),
        "xmlp_fc1_kernel": ("xmlp", "fc1", "kernel"),
        "xmlp_fc1_bias": ("xmlp", "fc1", "bias"),
        "xmlp_fc2_kernel": ("xmlp", "fc2", "kernel"),
        "xmlp_fc2_bias": ("xmlp", "fc2", "bias"),
    },
    "gpt2": {
        "gate_attn": ("alpha_cattn",),
        "lnx_scale": ("ln_cross_attn", "scale"),
        "lnx_bias": ("ln_cross_attn", "bias"),
        "xattn_q_kernel": ("crossattention", "q_attn", "kernel"),
        "xattn_q_bias": ("crossattention", "q_attn", "bias"),
        "xattn_kv_kernel": ("crossattention", "c_attn", "kernel"),
        "xattn_kv_bias": ("crossattention", "c_attn", "bias"),
        "xattn_out_kernel": ("crossattention", "c_proj", "kernel"),
        "xattn_out_bias": ("crossattention", "c_proj", "bias"),
        "gate_mlp": ("alpha_dense",),
        "lnxm_scale": ("ln_2_crossattention", "scale"),
        "lnxm_bias": ("ln_2_crossattention", "bias"),
        "xmlp_fc1_kernel": ("mlp_crossattention", "c_fc", "kernel"),
        "xmlp_fc1_bias": ("mlp_crossattention", "c_fc", "bias"),
        "xmlp_fc2_kernel": ("mlp_crossattention", "c_proj", "kernel"),
        "xmlp_fc2_bias": ("mlp_crossattention", "c_proj", "bias"),
    },
}

def make_group_forward(*, cross_position: str = "mid",
                       remat: bool = False) -> Callable:
    """``group_forward(blocks, h, enc) -> h`` applying one ``[cross-block,
    plain x (cross_every - 1)]`` group of the port's blocks:
    ``cross_position`` ``"mid"`` (the VCLM's blocks: attn, cross, MLP) or
    ``"pre"`` (GPT-2's: cross, attn, MLP).  With ``remat`` the group runs
    under activation checkpointing when a gradient is taken."""
    if cross_position not in ("mid", "pre"):
        raise ValueError(f"cross_position must be 'mid' or 'pre', got "
                         f"{cross_position!r}")

    def run(blocks: Sequence[nn.Module], h: torch.Tensor,
            enc: torch.Tensor) -> torch.Tensor:
        for blk in blocks:
            h = blk(h, enc)
        return h

    def group_forward(blocks, h, enc):
        if remat and torch.is_grad_enabled():
            return checkpoint(run, blocks, h, enc, use_reentrant=False)
        return run(blocks, h, enc)

    return group_forward


class PipelinedGatedDecoder(nn.ModuleList):
    """A gated decoder's block stack as a GPipe pipeline over the current
    mesh's ``pp`` axis, the units its ``G = layers / cross_every``
    groups; iterating it gives its blocks, so the names are the
    sequential stack's.  ``gated`` (GPT-2) must be true, as in JAX."""

    unit_name = "groups"

    def __init__(self, width: int, layers: int, heads: int,
                 cross_every: int = 2, cross_position: str = "mid",
                 dtype: torch.dtype = torch.bfloat16,
                 num_microbatches: int = 8, remat: bool = False,
                 gated: bool = True):
        if layers % cross_every:
            raise ValueError(f"{layers} layers do not divide into groups of "
                             f"cross_every={cross_every}")
        if cross_position == "pre":
            from avion_tpu_torch.models.gpt2_gated import GatedGPT2Block

            if not gated:
                raise NotImplementedError(
                    "pipelined GPT-2 supports the gated-xattn variant")
            blocks = [GatedGPT2Block(width, heads,
                                     has_cross=(i % cross_every == 0),
                                     gated=True, dtype=dtype)
                      for i in range(layers)]
        elif cross_position == "mid":
            from avion_tpu_torch.models.narrator import GatedDecoderBlock

            blocks = [GatedDecoderBlock(width, heads, dtype,
                                        cross_attend=(i % cross_every == 0))
                      for i in range(layers)]
        else:
            raise ValueError(f"cross_position must be 'mid' or 'pre', got "
                             f"{cross_position!r}")
        super().__init__(blocks)
        self.cross_every = cross_every
        self.cross_position = cross_position
        self.num_microbatches = num_microbatches
        self.remat = remat
        self.group_forward = make_group_forward(
            cross_position=cross_position, remat=remat)

    def units(self) -> List[List[nn.Module]]:
        c = self.cross_every
        blocks = list(self)
        return [blocks[k:k + c] for k in range(0, len(blocks), c)]

    def run_units(self, units, h: torch.Tensor,
                  enc: torch.Tensor) -> torch.Tensor:
        for group in units:
            h = self.group_forward(group, h, enc)
        return h

    def forward(self, x: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
        """x [B, S, W], enc [B, M, W_enc] (every row's visual tokens)."""
        return gpipe_grouped(self, x, enc)


def gpipe_grouped(decoder: PipelinedGatedDecoder, x: torch.Tensor,
                  enc: torch.Tensor) -> torch.Tensor:
    """The decoder's groups over the current mesh's pipeline (in sequence
    without one), each stage using the visual tokens ``enc`` of the
    microbatch it holds."""
    pre = decoder.cross_position == "pre"  # f32 after a gated cross
    return run_pipelined(decoder, x, enc, torch.float32 if pre else x.dtype)


def _detect_fmt(block: Dict) -> str:
    return "vclm" if "qkv" in block.get("attn", {}) else "gpt2"


def stack_gated_params(decoder_params: Dict, *, prefix: str) -> Dict:
    """A flax decoder's sequential ``{prefix}{i}`` tree -> the JAX
    group-stacked flat tree (numpy): self leaves ``[G, cross_every, ...]``,
    cross leaves ``[G, ...]``.  ``prefix`` is ``"block_"`` (VCLM) or
    ``"h_"`` (GPT-2); ``cross_every`` is inferred from which blocks carry
    cross parameters."""
    layers = sum(1 for k in decoder_params if k.startswith(prefix))
    if not layers:
        raise ValueError(f"no {prefix}* blocks in the tree")
    blocks = [decoder_params[f"{prefix}{i}"] for i in range(layers)]
    fmt = _detect_fmt(blocks[0])
    cross_key = "xattn" if fmt == "vclm" else "crossattention"
    g = sum(1 for b in blocks if cross_key in b)
    if not g or layers % g:
        raise ValueError(f"{layers} blocks, {g} with cross-attention")
    c = layers // g
    out: Dict[str, Any] = {}
    for name, path in _SELF_PATHS[fmt].items():
        stacked = np.stack([np.asarray(_get(b, path)) for b in blocks])
        out[name] = stacked.reshape(g, c, *stacked.shape[1:])
    for name, path in _CROSS_PATHS[fmt].items():
        out[name] = np.stack([np.asarray(_get(blocks[i * c], path))
                              for i in range(g)])
    return out


def unstack_gated_params(stacked: Dict, *, prefix: str) -> Dict:
    """Inverse of :func:`stack_gated_params`."""
    fmt = "vclm" if prefix == "block_" else "gpt2"
    g, c = np.shape(stacked["qkv_kernel"])[:2]
    out: Dict[str, Any] = {}
    for gi in range(g):
        for ci in range(c):
            blk: Dict[str, Any] = {}
            for name, path in _SELF_PATHS[fmt].items():
                _put(blk, path, np.asarray(stacked[name])[gi, ci])
            if ci == 0:
                for name, path in _CROSS_PATHS[fmt].items():
                    _put(blk, path, np.asarray(stacked[name])[gi])
            out[f"{prefix}{gi * c + ci}"] = blk
    return out
