"""Embedding sweeps and the zero-shot text classifier
(``avion_tpu.eval.runners``).

Eager PyTorch compiles nothing per shape, so :class:`CLIPEncoders`
chunks inputs at ``batch`` rows WITHOUT padding the last chunk to a static
size (the JAX runner pads so that XLA compiles once); rows are
independent, so the embeddings are the same.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import numpy as np
import torch

from avion_tpu_torch.data.tokenizer import tokenize
from avion_tpu_torch.data.transforms import normalize_video

ZERO_SHOT_TEMPLATES = ["#C C {}", "#C {}"]  # avion_tpu/eval/classification_metrics.py

# parameters consumed at f32 BEFORE the compute-dtype cast (positional,
# temporal and token embeddings); rounding them early would change outputs
_CAST_EXCLUDE = ("positional", "temporal", "token_embedding")


def cast_inference_params(model: torch.nn.Module) -> torch.nn.Module:
    """Pre-cast the matrix parameters (ndim >= 2) of a bf16-compute model
    to bf16, in place, skipping ``_CAST_EXCLUDE``.  Numerically the same
    as keeping them f32 (each dense layer rounds its weight to the compute
    dtype at use), but it halves the weight bytes each forward reads.
    Vectors and scalars (biases, LayerNorm, class embedding, logit scale)
    stay f32.  A no-op for an f32-compute model."""
    if model.dtype != torch.bfloat16:
        return model
    with torch.no_grad():
        for name, p in model.named_parameters():
            if (p.dim() >= 2 and p.dtype == torch.float32
                    and not any(k in name.lower() for k in _CAST_EXCLUDE)):
                p.data = p.data.to(torch.bfloat16)
    return model


class CLIPEncoders:
    """Batched encode functions over a CLIP model on one device.

    ``weight_dtype``: ``bf16`` pre-casts the matrices
    (:func:`cast_inference_params`), ``f32`` keeps them.  Every call
    enters ``torch.inference_mode()`` and the model's CUDA device itself:
    both are thread-local, and the server calls from its batcher threads.
    """

    def __init__(self, model, batch: int = 64, weight_dtype: str = "bf16"):
        if weight_dtype == "bf16":
            cast_inference_params(model)
        elif weight_dtype != "f32":
            raise ValueError(f"weight_dtype must be bf16|f32 in this port, "
                             f"got {weight_dtype!r}")
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.batch = batch
        # tower forwards run, one per chunk (served as /metrics 'encoder')
        self.image_calls = 0
        self.text_calls = 0

    def _context(self):
        stack = contextlib.ExitStack()
        stack.enter_context(torch.inference_mode())
        if self.device.type == "cuda":
            stack.enter_context(torch.cuda.device(self.device))
        return stack

    def _sweep(self, fn, arr: np.ndarray) -> np.ndarray:
        out = []
        with self._context():
            for i in range(0, arr.shape[0], self.batch):
                chunk = torch.from_numpy(np.ascontiguousarray(
                    arr[i : i + self.batch])).to(self.device)
                out.append(fn(chunk).float().cpu().numpy())
        return np.concatenate(out, axis=0)

    def _img(self, video: torch.Tensor) -> torch.Tensor:
        self.image_calls += 1
        v = normalize_video(video, dtype=self.model.dtype)
        return self.model.encode_image(v)

    def _txt(self, text: torch.Tensor) -> torch.Tensor:
        self.text_calls += 1
        return self.model.encode_text(text.long())

    def encode_images(self, videos: np.ndarray) -> np.ndarray:
        """uint8 [N, T, H, W, 3] -> [N, D] f32 unit embeddings."""
        return self._sweep(self._img, videos)

    def encode_texts(self, texts: np.ndarray) -> np.ndarray:
        """int token ids [N, L] -> [N, D] f32 unit embeddings."""
        return self._sweep(self._txt, texts)

    def logit_scale(self) -> float:
        return float(self.model.logit_scale.detach().float().cpu())


def build_text_classifier(encoders: CLIPEncoders, labels: Sequence[str],
                          templates: Sequence[str] = tuple(ZERO_SHOT_TEMPLATES),
                          context_length: int = 77) -> np.ndarray:
    """Prompt-ensemble classifier weights [n_classes, D]: encode each
    template-filled label, mean over templates, renormalize."""
    weights = []
    for label in labels:
        toks = tokenize([t.format(label) for t in templates], context_length)
        emb = encoders.encode_texts(toks)
        mean = emb.mean(axis=0)
        weights.append(mean / max(np.linalg.norm(mean), 1e-8))
    return np.stack(weights)
