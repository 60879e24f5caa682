"""Model registry: name -> factory (``avion_tpu.models.registry``).

The CLIP entries of the JAX registry, with the same names and factory
keyword arguments.  ``use_flash_attn`` is accepted and ignored: attention
always goes through ``ops.flash_attention``, which runs the CUDA kernels
for CUDA tensors.  Machinery of later slices (sequence parallelism, MoE,
pipelining, the SigLIP logit bias, pooling other than CLS) raises when it
is asked for.  ``CLIP.init_weights`` draws the flax initializers'
distributions; the constructors' own draws are placeholders.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from avion_tpu_torch.models.clip import CLIP

_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def list_models():
    return sorted(_REGISTRY)


def create_model(name: str, **kwargs):
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {list_models()}")
    return _REGISTRY[name](**kwargs)


_LATER = {"sequence_parallel": False, "moe_experts": 0, "pipeline": False,
          "use_logit_bias": False}


def _training_kwargs(pooling: str = "cls", use_grad_checkpointing=False,
                     remat_policy: str = "save_attn",
                     patch_dropout: float = 0.0, input_norm: str = "none",
                     freeze_temperature: bool = False,
                     use_flash_attn: bool = True,
                     pipeline_microbatches: int = 8, **later) -> dict:
    """The CLIP keywords the train entry passes, checked."""
    del use_flash_attn, pipeline_microbatches
    if pooling != "cls":
        raise ValueError(f"the PyTorch port pools the CLS token only, "
                         f"got pooling={pooling!r}")
    for key, value in later.items():
        if key not in _LATER:
            raise TypeError(f"unexpected model keyword {key!r}")
        if value != _LATER[key]:
            raise NotImplementedError(
                f"{key}={value!r} is not in the PyTorch port yet")
    return dict(remat=bool(use_grad_checkpointing), remat_policy=remat_policy,
                patch_dropout=patch_dropout, input_norm=input_norm,
                freeze_temperature=freeze_temperature)


def _clip_factory(*, patch_size, vision_width, vision_layers, vision_heads,
                  image_size=224, text_width=512, text_heads=8,
                  text_layers=12):
    def build(num_frames: int = 16, project_embed_dim: int = 512,
              use_quick_gelu: bool = True, temperature_init: float = 0.07,
              dtype: Optional[torch.dtype] = None, **kwargs):
        return CLIP(
            embed_dim=project_embed_dim, image_size=image_size,
            patch_size=patch_size, num_frames=num_frames,
            vision_width=vision_width, vision_layers=vision_layers,
            vision_heads=vision_heads, text_width=text_width,
            text_heads=text_heads, text_layers=text_layers,
            use_quick_gelu=use_quick_gelu, temperature_init=temperature_init,
            dtype=dtype if dtype is not None else torch.bfloat16,
            **_training_kwargs(**kwargs))

    return build


register_model("CLIP_VITB16")(
    _clip_factory(patch_size=16, vision_width=768, vision_layers=12,
                  vision_heads=12))
# same widths and parameters as CLIP_VITB16, 6 heads of dim 128
register_model("CLIP_VITB16_H128")(
    _clip_factory(patch_size=16, vision_width=768, vision_layers=12,
                  vision_heads=6))


@register_model("CLIP_TINY")
def _clip_tiny(num_frames: int = 2, project_embed_dim: int = 32,
               use_quick_gelu: bool = True, temperature_init: float = 0.07,
               dtype: Optional[torch.dtype] = None, **kwargs):
    """Miniature CLIP for smoke tests (not in the reference)."""
    return CLIP(
        embed_dim=project_embed_dim, image_size=32, patch_size=16,
        num_frames=num_frames, vision_width=64, vision_layers=2,
        vision_heads=2, context_length=77, vocab_size=49408, text_width=32,
        text_heads=2, text_layers=2, use_quick_gelu=use_quick_gelu,
        temperature_init=temperature_init,
        dtype=dtype if dtype is not None else torch.float32,
        **_training_kwargs(**kwargs))
