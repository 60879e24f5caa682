"""The released LaViLa narrator checkpoint (TimeSformer + gated GPT-2 XL)
into the port's ``models.lavila.LavilaNarrator``
(``avion_tpu.models.lavila_import``).

The port's modules carry the released layout's own names and shapes, so
the import only:

- strips DDP's ``module.`` prefix;
- turns the gamma-only pool LayerNorms (``img_attn_pool.norm``,
  ``img_attn_pool.context_norm``, ``img_attn_pool_norm``) into a weight
  and a zero bias;
- drops what is no parameter of the model: the LM head tied to ``wte``
  (``text_decoder.lm_head.weight``) and HF GPT-2's causal-mask buffers
  (``attn.bias``, ``attn.masked_bias``);
- gives the scalar gates (``alpha_*``) the shape ``()``.

:func:`load_lavila_narrator` then loads with ``strict=True``, so a file
that misses a block (or holds one the model lacks) raises; a file without
any TimeSformer or GPT-2 block raises in :func:`import_lavila_narrator_pt`
and names what it holds.
"""

from __future__ import annotations

import re
from typing import Dict

import torch

from avion_tpu_torch.models.pt_import import _layout, load_pt_state_dict

_GAMMA_ONLY = ("img_attn_pool.norm", "img_attn_pool.context_norm",
               "img_attn_pool_norm")
_DROPPED = re.compile(r"^text_decoder\.lm_head\.weight$"
                      r"|\.(attn|crossattention)\.(bias|masked_bias)$")


def import_lavila_narrator_pt(path_or_state) -> Dict[str, torch.Tensor]:
    """A released narrator ``.pt`` (or its state dict) -> the port's
    ``LavilaNarrator`` state dict (f32)."""
    state = (load_pt_state_dict(path_or_state)
             if isinstance(path_or_state, str)
             else {(k[len("module."):] if k.startswith("module.") else k):
                   torch.as_tensor(v).float()
                   for k, v in path_or_state.items()})
    for prefix in ("visual.blocks.", "text_decoder.transformer.h."):
        if not any(k.startswith(prefix) for k in state):
            where = (path_or_state if isinstance(path_or_state, str)
                     else "the state dict")
            raise ValueError(f"no LaViLa narrator block ({prefix}N.*) in "
                             f"{where}: it holds {_layout(state)}")
    out: Dict[str, torch.Tensor] = {}
    for k, v in state.items():
        if _DROPPED.search(k):
            continue
        base = k[:-len(".gamma")] if k.endswith(".gamma") else None
        if base in _GAMMA_ONLY:
            out[f"{base}.weight"] = v
            out[f"{base}.bias"] = torch.zeros_like(v)
        elif k.rsplit(".", 1)[-1].startswith("alpha_"):
            out[k] = v.reshape(())
        else:
            out[k] = v
    return out


def load_lavila_narrator(model: torch.nn.Module, path_or_state) -> None:
    """Load a released narrator checkpoint into a port ``LavilaNarrator``
    with ``strict=True``."""
    model.load_state_dict(import_lavila_narrator_pt(path_or_state),
                          strict=True)
