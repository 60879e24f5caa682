"""EgoVLP legacy feature extractor: the FrozenInTime dual encoder
(``avion_tpu.egonlq.egovlp``).

Kept for released EgoVLP checkpoints (the reference's
``egonlq/model/model.py:46-339``): a SpaceTimeTransformer video tower
(``models.timesformer``, the LaViLa narrator's, here with exact-erf GELU,
no ``ln_pre``, no time gate and LayerNorm eps 1e-5), a RoBERTa-base text
tower (post-LN encoder) and the 4096-wide "minimal" projection MLPs.  Only
the feature surface is ported (``compute_video`` / ``compute_text``,
``model.py:263-296``); the fusion / ITM / MLM heads are EgoVLP training
machinery, and their checkpoint entries are dropped on import.

The modules carry the released state dict's names (``video_model.*``,
``text_model.embeddings.*``, ``text_model.encoder.layer.N.attention.
self.query``, ..., ``vid_proj.0`` / ``.2`` / ``.4``), so
:func:`import_egovlp_state` only strips ``module.``, drops the training
heads (``qkv_text_i2t``, ``alpha_*``, ``cross_modal_*``, ``mlm_score``,
``itm_score``, the text pooler, HF's ``position_ids`` buffer) and fills
or cuts the temporal embedding to the clip length
(``load_temporal_fix='zeros'``, ``model.py:297-339``).

Everything runs in f32 (the JAX extractor keeps the checkpoint's dtype),
and no attention here reaches a kernel: the divided space-time attention
and RoBERTa's attention are plain math, as in the JAX package.  Video is
normalized with ImageNet's mean and std (x 255), not OpenAI's.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from avion_tpu_torch.egonlq.features import FeatureExtractor
from avion_tpu_torch.models.timesformer import SpaceTimeTransformer

ROBERTA_PAD_ID = 1
LN_EPS = 1e-5
# the EgoVLP extractor's input transform (ImageNet statistics), on 0..255
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class RobertaLayer(nn.Module):
    """One post-LN RoBERTa encoder block (self-attention + FFN), with the
    HuggingFace layout's names."""

    def __init__(self, width: int, heads: int, mlp_dim: int):
        super().__init__()
        self.heads = heads
        self.attention = nn.ModuleDict({
            "self": nn.ModuleDict({n: nn.Linear(width, width)
                                   for n in ("query", "key", "value")}),
            "output": nn.ModuleDict({
                "dense": nn.Linear(width, width),
                "LayerNorm": nn.LayerNorm(width, eps=LN_EPS)})})
        self.intermediate = nn.ModuleDict({"dense": nn.Linear(width,
                                                              mlp_dim)})
        self.output = nn.ModuleDict({
            "dense": nn.Linear(mlp_dim, width),
            "LayerNorm": nn.LayerNorm(width, eps=LN_EPS)})

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, s, w = x.shape
        d = w // self.heads
        qkv = self.attention["self"]
        q, k, v = (qkv[n](x).reshape(b, s, self.heads, d).transpose(1, 2)
                   for n in ("query", "key", "value"))
        logits = q @ k.transpose(-1, -2) / math.sqrt(d)
        ctx = torch.softmax(logits + bias, dim=-1) @ v
        ctx = ctx.transpose(1, 2).reshape(b, s, w)
        out = self.attention["output"]
        x = out["LayerNorm"](x + out["dense"](ctx))
        y = F.gelu(self.intermediate["dense"](x))  # exact erf
        return self.output["LayerNorm"](x + self.output["dense"](y))


class RobertaModel(nn.Module):
    """RoBERTa-base encoder: embeddings and post-LN layers; returns the
    last hidden state [B, S, W] (``compute_text`` pools token 0)."""

    def __init__(self, vocab_size: int = 50265, width: int = 768,
                 layers: int = 12, heads: int = 12, mlp_dim: int = 3072,
                 max_positions: int = 514,
                 pad_token_id: int = ROBERTA_PAD_ID):
        super().__init__()
        self.pad_token_id = pad_token_id
        self.embeddings = nn.ModuleDict({
            "word_embeddings": nn.Embedding(vocab_size, width),
            "position_embeddings": nn.Embedding(max_positions, width),
            "token_type_embeddings": nn.Embedding(1, width),
            "LayerNorm": nn.LayerNorm(width, eps=LN_EPS)})
        self.encoder = nn.ModuleDict({"layer": nn.ModuleList(
            RobertaLayer(width, heads, mlp_dim) for _ in range(layers))})

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        nonpad = (input_ids != self.pad_token_id).long()
        if attention_mask is None:
            attention_mask = nonpad
        # RoBERTa's position ids: the running count of non-pad tokens,
        # offset past the pad id (create_position_ids_from_input_ids)
        pos_ids = torch.cumsum(nonpad, dim=1) * nonpad + self.pad_token_id
        emb = self.embeddings
        x = (emb["word_embeddings"](input_ids)
             + emb["position_embeddings"](pos_ids)
             + emb["token_type_embeddings"](torch.zeros_like(input_ids)))
        x = emb["LayerNorm"](x)
        bias = ((1 - attention_mask).float() * -1e9)[:, None, None, :]
        for layer in self.encoder["layer"]:
            x = layer(x, bias)
        return x


def projection_mlp(width: int, dim: int) -> nn.Sequential:
    """The 'minimal' projection (``model.py:106-119``): Linear (no bias),
    ReLU, Linear, ReLU, Linear (keys ``0``, ``2``, ``4``)."""
    return nn.Sequential(nn.Linear(width, dim, bias=False), nn.ReLU(),
                         nn.Linear(dim, dim), nn.ReLU(), nn.Linear(dim, dim))


class FrozenInTime(nn.Module):
    """EgoVLP dual encoder (feature surface), f32.

    ``compute_video``: [B, T, H, W, C] float video (ImageNet-normalized)
    -> [B, projection_dim]; ``compute_text``: RoBERTa ids (and mask) ->
    [B, projection_dim]."""

    def __init__(self, num_frames: int = 4, image_size: int = 224,
                 patch_size: int = 16, width: int = 768, layers: int = 12,
                 heads: int = 12, projection_dim: int = 4096,
                 text_layers: int = 12, vocab_size: int = 50265,
                 max_positions: int = 514):
        super().__init__()
        self.num_frames, self.image_size = num_frames, image_size
        self.video_model = SpaceTimeTransformer(
            image_size=image_size, patch_size=patch_size,
            num_frames=num_frames, width=width, layers=layers, heads=heads,
            act=F.gelu, ln_pre=False, gated_timeattn=False,
            ln_eps=LN_EPS, dtype=torch.float32)
        self.text_model = RobertaModel(
            vocab_size=vocab_size, width=width, layers=text_layers,
            heads=heads, mlp_dim=4 * width, max_positions=max_positions)
        self.vid_proj = projection_mlp(width, projection_dim)
        self.txt_proj = projection_mlp(width, projection_dim)

    def compute_video(self, video: torch.Tensor) -> torch.Tensor:
        return self.vid_proj(self.video_model(video, cls_at_last=True))

    def compute_text(self, input_ids: torch.Tensor,
                     attention_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        return self.txt_proj(self.text_model(input_ids, attention_mask)[:, 0])

    def forward(self, video, input_ids, attention_mask=None) -> dict:
        return {"video_embed": self.compute_video(video),
                "text_embed": self.compute_text(input_ids, attention_mask)}


_TOWERS = ("video_model.", "text_model.", "vid_proj.", "txt_proj.")
# entries of released checkpoints that feature extraction does not read:
# the FIBER fusion blocks' params, the text pooler and HF's position-id
# buffer
_NOT_READ = ("qkv_text_i2t", "alpha_", "text_model.pooler.",
             "position_ids")


def import_egovlp_state(sd: Dict[str, torch.Tensor], *,
                        num_frames: int = 4) -> Dict[str, torch.Tensor]:
    """A released EgoVLP ``state_dict`` (tensors or numpy arrays) ->
    :class:`FrozenInTime`'s state dict: ``module.`` stripped, the training
    heads dropped, ``video_model.temporal_embed`` zero-filled or cut to
    ``num_frames``; every tensor f32 on the CPU."""
    out = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if not k.startswith(_TOWERS) or any(s in k for s in _NOT_READ):
            continue
        out[k] = torch.as_tensor(np.asarray(v, np.float32))
    tload = out["video_model.temporal_embed"]  # [1, T_load, W]
    temporal = torch.zeros(1, num_frames, tload.shape[-1])
    t = min(num_frames, tload.shape[1])
    temporal[:, :t] = tload[:, :t]
    out["video_model.temporal_embed"] = temporal
    return out


def load_egovlp_checkpoint(path_or_state, *, num_frames: int = 4,
                           heads: Optional[int] = None) -> FrozenInTime:
    """A :class:`FrozenInTime` holding a released EgoVLP ``.pth`` / ``.pt``
    checkpoint (or its state dict): every parameter of the model is read
    (a missing one raises ``KeyError``), other entries are not, as the JAX
    importer reads only what it knows.  Depth,
    width, image size, projection width, vocabulary and position-table
    sizes come from the state dict; ``heads`` falls back to width / 64
    (12 for the released roberta-base-width models)."""
    from avion_tpu_torch.models.pt_import import load_pt_state_dict

    raw = (load_pt_state_dict(path_or_state)
           if isinstance(path_or_state, str) else path_or_state)
    sd = import_egovlp_state(raw, num_frames=num_frames)
    layers = 1 + max(int(k.split(".")[2]) for k in sd
                     if k.startswith("video_model.blocks."))
    text_layers = 1 + max(int(k.split(".")[3]) for k in sd
                          if k.startswith("text_model.encoder.layer."))
    pos = sd["video_model.pos_embed"]  # [1, n + 1, W]
    patch = sd["video_model.patch_embed.proj.weight"].shape[-1]
    width = pos.shape[-1]
    vocab, _ = sd["text_model.embeddings.word_embeddings.weight"].shape
    max_positions = sd[
        "text_model.embeddings.position_embeddings.weight"].shape[0]
    model = FrozenInTime(
        num_frames=num_frames,
        image_size=int(round(math.sqrt(pos.shape[1] - 1))) * patch,
        patch_size=patch, width=width, layers=layers,
        heads=heads or max(1, width // 64),
        projection_dim=sd["vid_proj.4.weight"].shape[0],
        text_layers=text_layers, vocab_size=vocab,
        max_positions=max_positions)
    model.load_state_dict({k: sd[k] for k in model.state_dict()})
    return model


class EgoVLPFeatureExtractor(FeatureExtractor):
    """NLQ feature extraction over the legacy EgoVLP dual encoder: the
    windowed sweep, ``extract_to_dir`` and its ``.npz`` layout are
    :class:`~avion_tpu_torch.egonlq.features.FeatureExtractor`'s; the
    model keeps its f32 weights.

    ``tokenizer``: anything with ``__call__(list[str], padding=True,
    return_tensors="np") -> {"input_ids", "attention_mask"}``
    (``data.roberta_tokenizer.RobertaTokenizer``, or a local-path HF
    tokenizer); or pass ids to :meth:`text_features_from_ids`."""

    def __init__(self, model: FrozenInTime, *, tokenizer=None,
                 clip_length: int = 4, window_sec: float = 2.0,
                 fps: float = 30.0, crop_size: int = 224, batch: int = 32):
        super().__init__(model, clip_length=clip_length,
                         window_sec=window_sec, fps=fps,
                         crop_size=crop_size, batch=batch)
        self.tokenizer = tokenizer

    @staticmethod
    def _prepare(model):
        return model.eval()  # the checkpoint's f32 weights, as in JAX

    @torch.inference_mode()
    def _vis(self, video: np.ndarray) -> np.ndarray:
        v = torch.from_numpy(video).to(self.device).float()
        mean = torch.tensor(IMAGENET_MEAN, device=v.device) * 255.0
        std = torch.tensor(IMAGENET_STD, device=v.device) * 255.0
        return self.model.compute_video((v - mean) / std).cpu().numpy()

    def _text_features(self, queries) -> np.ndarray:
        if self.tokenizer is None:
            raise ValueError(
                "no tokenizer configured: pass tokenizer= (a "
                "data.roberta_tokenizer.RobertaTokenizer) or use "
                "text_features_from_ids")
        enc = self.tokenizer(list(queries), padding=True,
                             return_tensors="np")
        return self.text_features_from_ids(
            np.asarray(enc["input_ids"]), np.asarray(enc["attention_mask"]))

    @torch.inference_mode()
    def text_features_from_ids(self, input_ids: np.ndarray,
                               attention_mask: Optional[np.ndarray] = None
                               ) -> np.ndarray:
        ids = torch.as_tensor(np.asarray(input_ids, np.int64),
                              device=self.device)
        mask = (ids != ROBERTA_PAD_ID).long() if attention_mask is None \
            else torch.as_tensor(np.asarray(attention_mask, np.int64),
                                 device=self.device)
        return self.model.compute_text(ids, mask).cpu().numpy()
