"""CLIP text transformer (``avion_tpu.models.text``):
token + learned positional embedding, a causal transformer (causality
inside the attention kernel), ``ln_final``, EOT pooling (argmax over the
token ids; EOT is the highest id).  The projection to the joint space
lives in ``clip.CLIP`` as ``text_projection``."""

from __future__ import annotations

import torch
from torch import nn

from avion_tpu_torch.models.layers import LayerNorm, Transformer, gelu


class TextTransformer(nn.Module):
    def __init__(self, context_length: int = 77, vocab_size: int = 49408,
                 width: int = 512, heads: int = 8, layers: int = 12, act=gelu,
                 dtype: torch.dtype = torch.bfloat16, remat: bool = False,
                 remat_policy: str = "save_attn"):
        super().__init__()
        self.dtype = dtype
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(
            torch.randn(context_length, width) * 0.01)
        self.transformer = Transformer(width, layers, heads, act, dtype,
                                       causal=True, remat=remat,
                                       remat_policy=remat_policy)
        self.ln_final = LayerNorm(width, dtype)

    def forward(self, text: torch.Tensor) -> torch.Tensor:
        """text: [B, L] int token ids -> [B, width] pooled features."""
        x = self.token_embedding(text).to(self.dtype)
        x = x + self.positional_embedding[: x.shape[1]].to(self.dtype)[None]
        x = self.ln_final(self.transformer(x))
        eot = text.argmax(dim=-1)
        return x[torch.arange(x.shape[0], device=x.device), eot]
