"""VideoMAE (``avion_tpu.models.videomae``): masked-autoencoder pretraining
and the finetune ViT.

- Tubelet patchify is a channel-last reshape and one dense product: the
  clip becomes [B, N, ts*p*p*C] tube vectors in (ts, p_h, p_w, C) order.
- The encoder sees only the visible tokens: with tube masking the masked
  count is fixed, so a stable argsort of the mask splits the token indices
  into visible and masked ones in token order (the reference's
  ``x[~mask]``), and the visible pixel vectors are gathered BEFORE
  ``patch_embed`` (in the model dtype).
- The fixed sincos position tables are buffers (not persistent, not
  parameters), as in the JAX modules, where they are constants.
- The decoder takes the visible tokens and the learned ``mask_token`` (f32,
  cast at use), each with its position, and predicts the pixels of the
  masked tubes; ``decoder_head``, ``fc_norm`` and ``head`` compute in f32,
  and the finetune ViT's mean over tokens accumulates in f32.
- Attention goes through ``ops.flash_attention`` as in every tower.
- :meth:`init_weights` draws the flax initializers' distributions and
  fills the position tables; a model built on the meta device needs it.
- Under a profiler the pretraining forward records the spans
  ``avion.tower.encoder`` (the mask's split through ``encoder_to_decoder``)
  and ``avion.tower.decoder`` (the decoder's tokens through the head), and
  each tower's output carries the backward mark
  ``avion.tower.<tower>.bwd`` (``core.profiling``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from avion_tpu_torch.core.profiling import backward_mark, span
from avion_tpu_torch.models.layers import (LayerNorm, Transformer, dense,
                                           gelu, lecun_normal_)


def sincos_pos_embed(n_pos: int, dim: int) -> np.ndarray:
    """Fixed sinusoid table [n_pos, dim] f32."""
    pos = np.arange(n_pos)[:, None]
    i = np.arange(dim)[None, :]
    angle = pos / np.power(10000, 2 * (i // 2) / dim)
    table = np.zeros((n_pos, dim), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


def split_mask_indices(mask: torch.Tensor, n_visible: int):
    """mask: [B, N] bool (True = masked).  Returns (visible_idx [B, n_vis],
    masked_idx [B, N - n_vis]), each in token order (stable sort)."""
    order = torch.argsort(mask.to(torch.int32), dim=-1, stable=True)
    return order[:, :n_visible], order[:, n_visible:]


def _gather_tokens(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


def tube_patchify(video: torch.Tensor, patch_size: int,
                  tubelet_size: int) -> torch.Tensor:
    """[B, T, H, W, C] -> [B, N, tubelet*p*p*C] tube tokens (channel-last)."""
    b, t, h, w, c = video.shape
    p, ts = patch_size, tubelet_size
    gh, gw = h // p, w // p
    x = video.reshape(b, t // ts, ts, gh, p, gw, p, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)  # B, T', gh, gw, ts, p, p, C
    return x.reshape(b, (t // ts) * gh * gw, ts * p * p * c)


class _VideoMAEBase(nn.Module):
    def _table(self, name: str, n_pos: int, dim: int) -> None:
        self.register_buffer(name, torch.from_numpy(sincos_pos_embed(
            n_pos, dim)), persistent=False)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """Draw every parameter from ``generator`` as the flax modules'
        initializers do: dense kernels lecun-normal (truncated) with zero
        biases, LayerNorm ones and zeros, ``mask_token`` normal(0.02); and
        fill the sincos tables.  The parameters must be on ``generator``'s
        device."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, m.in_features, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        if hasattr(self, "mask_token"):
            self.mask_token.normal_(0.0, 0.02, generator=generator)
        for name, buf in self.named_buffers():
            buf.copy_(torch.from_numpy(sincos_pos_embed(*buf.shape)))
        return self

    def _drop_keep(self, encoder: Transformer, x: torch.Tensor,
                   deterministic: bool, generator):
        """The encoder's DropPath masks, drawn outside its (possibly
        rematerialized) blocks."""
        if deterministic:
            return None
        return encoder.draw_drop_path(x.shape[0], generator, x.device)


class PretrainVideoMAE(_VideoMAEBase):
    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 num_frames: int = 16, tubelet_size: int = 2,
                 encoder_width: int = 768, encoder_layers: int = 12,
                 encoder_heads: int = 12, decoder_width: int = 384,
                 decoder_layers: int = 4, decoder_heads: int = 6,
                 mask_ratio: float = 0.9, remat: bool = False,
                 remat_policy: str = "save_attn", drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.image_size, self.patch_size = image_size, patch_size
        self.num_frames, self.tubelet_size = num_frames, tubelet_size
        self.encoder_layers, self.mask_ratio = encoder_layers, mask_ratio
        self.dtype = dtype
        self.patch_embed = nn.Linear(self.patch_dim, encoder_width)
        self.encoder = Transformer(encoder_width, encoder_layers,
                                   encoder_heads, gelu, dtype, remat=remat,
                                   remat_policy=remat_policy,
                                   drop_path_rate=drop_path_rate)
        self.encoder_norm = LayerNorm(encoder_width, dtype)
        self.encoder_to_decoder = nn.Linear(encoder_width, decoder_width,
                                            bias=False)
        self.mask_token = nn.Parameter(torch.zeros(decoder_width))
        self.decoder = Transformer(decoder_width, decoder_layers,
                                   decoder_heads, gelu, dtype, remat=remat,
                                   remat_policy=remat_policy)
        self.decoder_norm = LayerNorm(decoder_width, dtype)
        self.decoder_head = nn.Linear(decoder_width, self.patch_dim)
        self._table("pos_embed", self.num_patches, encoder_width)
        self._table("decoder_pos_embed", self.num_patches, decoder_width)

    @property
    def num_patches(self) -> int:
        g = self.image_size // self.patch_size
        return (self.num_frames // self.tubelet_size) * g * g

    @property
    def n_visible(self) -> int:
        """The tube mask hides ``int(per_frame * ratio)`` tokens a frame."""
        g = self.image_size // self.patch_size
        n_frames = self.num_frames // self.tubelet_size
        return self.num_patches - int(g * g * self.mask_ratio) * n_frames

    @property
    def patch_dim(self) -> int:
        return self.tubelet_size * self.patch_size * self.patch_size * 3

    def forward(self, video: torch.Tensor, mask: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """video: [B, T, H, W, C] normalized; mask: [B, N] bool, True =
        masked, with the tube mask's fixed masked count.  Returns (pred
        [B, n_masked, patch_dim] f32, masked_idx [B, n_masked]).  With
        ``deterministic=False`` DropPath draws from ``generator``."""
        with span("avion.tower.encoder"):
            visible_idx, masked_idx = split_mask_indices(mask,
                                                         self.n_visible)
            tokens = tube_patchify(video, self.patch_size, self.tubelet_size)
            xv = dense(_gather_tokens(tokens.to(self.dtype), visible_idx),
                       self.patch_embed)
            xv = xv + self.pos_embed.to(self.dtype)[visible_idx]
            xv = self.encoder(xv, self._drop_keep(self.encoder, xv,
                                                  deterministic, generator))
            xv = backward_mark(
                dense(self.encoder_norm(xv), self.encoder_to_decoder),
                "avion.tower.encoder.bwd")
        with span("avion.tower.decoder"):
            dpos = self.decoder_pos_embed.to(self.dtype)
            b, n_masked = masked_idx.shape
            dm = self.mask_token.to(self.dtype).expand(
                b, n_masked, -1) + dpos[masked_idx]
            full = torch.cat([xv + dpos[visible_idx], dm], dim=1)
            full = self.decoder_norm(self.decoder(full))
            head = self.decoder_head
            pred = F.linear(full[:, -n_masked:].float(), head.weight.float(),
                            head.bias.float())
            return backward_mark(pred, "avion.tower.decoder.bwd"), masked_idx


class FinetuneVideoMAE(_VideoMAEBase):
    """Supervised video ViT: tubelet patchify, sincos positions, mean
    pooling, ``fc_norm``, dropout, a linear head."""

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 num_frames: int = 16, tubelet_size: int = 2,
                 width: int = 768, layers: int = 12, heads: int = 12,
                 num_classes: int = 400, remat: bool = False,
                 remat_policy: str = "save_attn", drop_path_rate: float = 0.1,
                 fc_drop_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.image_size, self.patch_size = image_size, patch_size
        self.num_frames, self.tubelet_size = num_frames, tubelet_size
        self.layers, self.fc_drop_rate = layers, fc_drop_rate
        self.dtype = dtype
        g = image_size // patch_size
        n = (num_frames // tubelet_size) * g * g
        self.patch_embed = nn.Linear(tubelet_size * patch_size ** 2 * 3, width)
        self.encoder = Transformer(width, layers, heads, gelu, dtype,
                                   remat=remat, remat_policy=remat_policy,
                                   drop_path_rate=drop_path_rate)
        self.fc_norm = LayerNorm(width, torch.float32)
        self.head = nn.Linear(width, num_classes)
        self._table("pos_embed", n, width)

    def forward(self, video: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """video: [B, T, H, W, C] normalized -> logits [B, classes] f32.
        With ``deterministic=False`` DropPath and the head's dropout draw
        from ``generator``."""
        x = tube_patchify(video.to(self.dtype), self.patch_size,
                          self.tubelet_size)
        x = dense(x, self.patch_embed) + self.pos_embed.to(self.dtype)[None]
        x = self.encoder(x, self._drop_keep(self.encoder, x, deterministic,
                                            generator))
        x = self.fc_norm(x.float().mean(dim=1).to(self.dtype))
        if self.fc_drop_rate > 0.0 and not deterministic:
            keep = 1.0 - self.fc_drop_rate
            mask = torch.rand(x.shape, generator=generator,
                              device=x.device) < keep
            x = torch.where(mask, x / keep, 0.0)
        return F.linear(x, self.head.weight.float(), self.head.bias.float())
