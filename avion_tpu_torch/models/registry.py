"""Model registry: name -> factory (``avion_tpu.models.registry``).

The CLIP, VideoMAE and narrator entries of the JAX registry, with the same
names and factory keyword arguments.  The VideoMAE factories, as the JAX ones, take
and ignore keywords they have no use for.  ``use_flash_attn`` is accepted and ignored: attention
always goes through ``ops.flash_attention``, which runs the CUDA kernels
for CUDA tensors.  ``sequence_parallel`` builds the ring-attention visual
tower (``models.vit``), ``moe_experts`` its mixture-of-experts blocks
(``ops.moe``), ``pipeline`` its GPipe stack (``parallel.pipeline``; the
VCLM's decoder through ``parallel.pipeline_gated``).
``CLIP.init_weights`` draws the flax initializers' distributions; the
constructors' own draws are placeholders.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from avion_tpu_torch.models.clip import CLIP
from avion_tpu_torch.models.lavila import LavilaNarrator
from avion_tpu_torch.models.narrator import VCLM
from avion_tpu_torch.models.videomae import FinetuneVideoMAE, PretrainVideoMAE

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


def _training_kwargs(pooling: str = "cls", use_grad_checkpointing=False,
                     remat_policy: str = "save_attn",
                     patch_dropout: float = 0.0, input_norm: str = "none",
                     freeze_temperature: bool = False,
                     use_logit_bias: bool = False,
                     use_flash_attn: bool = True,
                     pipeline_microbatches: int = 8,
                     sequence_parallel: bool = False, moe_experts: int = 0,
                     pipeline: bool = False) -> dict:
    """The CLIP keywords the train entry passes, checked (the visual
    tower refuses a pooling other than cls, gap or none)."""
    del use_flash_attn
    return dict(remat=bool(use_grad_checkpointing), remat_policy=remat_policy,
                patch_dropout=patch_dropout, input_norm=input_norm,
                freeze_temperature=freeze_temperature, pooling=pooling,
                use_logit_bias=use_logit_bias,
                sequence_parallel=bool(sequence_parallel),
                moe_experts=int(moe_experts), pipeline=bool(pipeline),
                pipeline_microbatches=int(pipeline_microbatches))


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
register_model("CLIP_VITL14")(
    _clip_factory(patch_size=14, vision_width=1024, vision_layers=24,
                  vision_heads=16, text_width=768, text_heads=12,
                  text_layers=12))
# same widths and parameters as CLIP_VITL14, 8 heads of dim 128
register_model("CLIP_VITL14_H128")(
    _clip_factory(patch_size=14, vision_width=1024, vision_layers=24,
                  vision_heads=8, text_width=768, text_heads=12,
                  text_layers=12))
register_model("CLIP_VITL14_336PX")(
    _clip_factory(patch_size=14, vision_width=1024, vision_layers=24,
                  vision_heads=16, image_size=336, text_width=768,
                  text_heads=12, text_layers=12))


@register_model("CLIP_TINY")
def _clip_tiny(num_frames: int = 2, project_embed_dim: int = 32,
               use_quick_gelu: bool = True, temperature_init: float = 0.07,
               dtype: Optional[torch.dtype] = None,
               pipeline_microbatches: int = 2, **kwargs):
    """Miniature CLIP for smoke tests (not in the reference)."""
    return CLIP(
        embed_dim=project_embed_dim, image_size=32, patch_size=16,
        num_frames=num_frames, vision_width=64, vision_layers=2,
        vision_heads=2, context_length=77, vocab_size=49408, text_width=32,
        text_heads=2, text_layers=2, use_quick_gelu=use_quick_gelu,
        temperature_init=temperature_init,
        dtype=dtype if dtype is not None else torch.float32,
        **_training_kwargs(pipeline_microbatches=pipeline_microbatches,
                           **kwargs))


@register_model("VIDEOMAE_TINY")
def _videomae_tiny(num_frames: int = 4, use_flash_attn: bool = False,
                   mask_ratio: float = 0.5, dtype=None, **_unused):
    """Miniature VideoMAE for smoke tests (not in the reference)."""
    return PretrainVideoMAE(
        image_size=32, patch_size=16, num_frames=num_frames, tubelet_size=2,
        encoder_width=48, encoder_layers=1, encoder_heads=2,
        decoder_width=32, decoder_layers=1, decoder_heads=2,
        mask_ratio=mask_ratio,
        dtype=dtype if dtype is not None else torch.float32)


@register_model("VIDEOMAE_TINY_FT")
def _videomae_tiny_ft(num_frames: int = 4, num_classes: int = 10,
                      use_flash_attn: bool = False, dtype=None, **_unused):
    return FinetuneVideoMAE(
        image_size=32, patch_size=16, num_frames=num_frames, tubelet_size=2,
        width=48, layers=1, heads=2, num_classes=num_classes,
        dtype=dtype if dtype is not None else torch.float32)


def _videomae_factory(encoder_heads: int, decoder_heads: int):
    def build(num_frames: int = 16, use_flash_attn: bool = True,
              use_grad_checkpointing: bool = False,
              remat_policy: str = "save_attn", decoder_depth: int = 4,
              drop_path_rate: float = 0.0, mask_ratio: float = 0.9,
              dtype=None, **_unused):
        return PretrainVideoMAE(
            image_size=224, patch_size=16, num_frames=num_frames,
            encoder_width=768, encoder_layers=12,
            encoder_heads=encoder_heads, decoder_width=384,
            decoder_layers=decoder_depth, decoder_heads=decoder_heads,
            tubelet_size=2, mask_ratio=mask_ratio,
            remat=use_grad_checkpointing, remat_policy=remat_policy,
            drop_path_rate=drop_path_rate,
            dtype=dtype if dtype is not None else torch.bfloat16)

    return build


register_model("VIDEOMAE_VITB16")(_videomae_factory(12, 6))
# the same widths, parameters and FLOPs with head_dim 128: encoder 6 x 128,
# decoder 3 x 128 (not for importing 12-head reference checkpoints)
register_model("VIDEOMAE_VITB16_H128")(_videomae_factory(6, 3))


@register_model("VIDEOMAE_VITB16_FT")
def _videomae_vitb16_ft(num_frames: int = 16, num_classes: int = 400,
                        use_flash_attn: bool = True,
                        use_grad_checkpointing: bool = False,
                        remat_policy: str = "save_attn",
                        drop_path_rate: float = 0.1,
                        fc_drop_rate: float = 0.0, dtype=None, **_unused):
    return FinetuneVideoMAE(
        image_size=224, patch_size=16, num_frames=num_frames, width=768,
        layers=12, heads=12, num_classes=num_classes, tubelet_size=2,
        remat=use_grad_checkpointing, remat_policy=remat_policy,
        drop_path_rate=drop_path_rate, fc_drop_rate=fc_drop_rate,
        dtype=dtype if dtype is not None else torch.bfloat16)


@register_model("VCLM_VITB16")
def _vclm_vitb16(num_frames: int = 4, use_flash_attn: bool = True,
                 cross_every: int = 2, dtype=None, pipeline: bool = False,
                 pipeline_microbatches: int = 8,
                 pipeline_remat: bool = False, vision_heads: int = 12,
                 heads: int = 8, **_unused):
    """Narrator VCLM: ViT-B/16 video tokens and a gated-cross-attention
    causal decoder (12 x 512, 8 heads).  ``vision_heads`` / ``heads`` give
    the head_dim-128 geometry (6 / 4) for narrators trained from scratch.
    ``pipeline`` pipelines the decoder over ``mesh.pp``
    (``parallel.pipeline_gated``; 6 groups)."""
    del use_flash_attn
    return VCLM(vocab_size=49408, context_length=77, width=512, layers=12,
                heads=heads, cross_every=cross_every, image_size=224,
                patch_size=16, num_frames=num_frames, vision_width=768,
                vision_layers=12, vision_heads=vision_heads,
                dtype=dtype if dtype is not None else torch.bfloat16,
                pipeline=pipeline,
                pipeline_microbatches=pipeline_microbatches,
                pipeline_remat=pipeline_remat)


@register_model("VCLM_OPENAI_TIMESFORMER_LARGE_336PX_GPT2_XL")
def _lavila_narrator_xl(num_frames: int = 4, gated_xattn: bool = True,
                        dtype=None, **_unused):
    """The released LaViLa narrator: TimeSformer-L at 336 px and gated
    GPT-2 XL, cross-attention every 3rd block (weights through
    ``models.lavila_import``)."""
    return LavilaNarrator(
        image_size=336, patch_size=14, num_frames=num_frames,
        vision_width=1024, vision_layers=24, vision_heads=16,
        vocab_size=50257, text_width=1600, text_layers=48, text_heads=25,
        cross_freq=3, gated_xattn=gated_xattn,
        dtype=dtype if dtype is not None else torch.bfloat16)


@register_model("LAVILA_NARRATOR_TINY")
def _lavila_narrator_tiny(num_frames: int = 2, gated_xattn: bool = True,
                          dtype=None, **_unused):
    """Miniature narrator for tests (not in the reference)."""
    return LavilaNarrator(
        image_size=32, patch_size=16, num_frames=num_frames,
        vision_width=48, vision_layers=2, vision_heads=2,
        vocab_size=96, text_width=32, text_layers=3, text_heads=2,
        cross_freq=3, gated_xattn=gated_xattn, num_img_queries=8,
        pool_heads=2, pool_dim_head=16,
        dtype=dtype if dtype is not None else torch.float32)
