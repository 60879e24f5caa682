"""Model registry: name -> factory (``avion_tpu.models.registry``).

The CLIP entries of the JAX registry, with the same names and factory
keyword arguments.  Keywords that select JAX-only machinery (flash on/off,
remat, sequence parallelism, MoE, pipelining) are accepted and ignored:
attention always goes through ``ops.flash_attention``, which runs the
CUDA kernel for CUDA tensors.
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


def _clip_factory(*, patch_size, vision_width, vision_layers, vision_heads,
                  image_size=224, text_width=512, text_heads=8,
                  text_layers=12):
    def build(num_frames: int = 16, project_embed_dim: int = 512,
              use_quick_gelu: bool = True, pooling: str = "cls",
              temperature_init: float = 0.07,
              dtype: Optional[torch.dtype] = None, **_unused):
        if pooling != "cls":
            raise ValueError(f"the PyTorch port pools the CLS token only, "
                             f"got pooling={pooling!r}")
        return CLIP(
            embed_dim=project_embed_dim, image_size=image_size,
            patch_size=patch_size, num_frames=num_frames,
            vision_width=vision_width, vision_layers=vision_layers,
            vision_heads=vision_heads, text_width=text_width,
            text_heads=text_heads, text_layers=text_layers,
            use_quick_gelu=use_quick_gelu, temperature_init=temperature_init,
            dtype=dtype if dtype is not None else torch.bfloat16)

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
               dtype: Optional[torch.dtype] = None, **_unused):
    """Miniature CLIP for smoke tests (not in the reference)."""
    return CLIP(
        embed_dim=project_embed_dim, image_size=32, patch_size=16,
        num_frames=num_frames, vision_width=64, vision_layers=2,
        vision_heads=2, context_length=77, vocab_size=49408, text_width=32,
        text_heads=2, text_layers=2, use_quick_gelu=use_quick_gelu,
        temperature_init=temperature_init,
        dtype=dtype if dtype is not None else torch.float32)
