"""Embedding sweeps, the zero-shot text classifier and the suites' runners
(``avion_tpu.eval.runners``).

Eager PyTorch compiles nothing per shape, so :class:`CLIPEncoders`
chunks inputs at ``batch`` rows WITHOUT padding the last chunk to a static
size (the JAX runner pads so that XLA compiles once); rows are
independent, so the embeddings are the same.  For the same reason there is
no ``CLIPEncoders.cached``: the JAX package keeps encoders across
validation epochs only so as not to recompile both towers.

The encoders cast the model they are given (:func:`cast_inference_params`
works in place) and switch it to eval mode; a training run therefore
evaluates a copy (``eval.validate.run_validation``).
"""

from __future__ import annotations

import contextlib
import time
import traceback
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from avion_tpu_torch.data.tokenizer import tokenize
from avion_tpu_torch.data.transforms import normalize_video
from avion_tpu_torch.eval.classification_metrics import (
    ZERO_SHOT_TEMPLATES,
    charades_map,
    confusion_matrix,
    egomcq_accuracy,
    get_marginal_indexes,
    marginalize,
    mean_class_accuracy,
    topk_accuracy,
)
from avion_tpu_torch.eval.retrieval_metrics import get_map, get_ndcg

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

    Counters: tower forwards (``image_calls`` / ``text_calls``, one per
    chunk; served as /metrics 'encoder'), rows encoded (``image_rows`` /
    ``text_rows``), seconds spent waiting for a loader's next batch
    (``data_wait_s``), and per suite of :func:`validate_all` the changes
    of these with the suite's wall time (``suite_stats``).
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
        self.image_calls = self.text_calls = 0
        self.image_rows = self.text_rows = 0
        self.data_wait_s = 0.0
        self.suite_stats: Dict[str, Dict[str, float]] = {}

    def counters(self) -> Dict[str, float]:
        return {"image_calls": self.image_calls,
                "text_calls": self.text_calls,
                "image_rows": self.image_rows, "text_rows": self.text_rows,
                "data_wait_s": self.data_wait_s}

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
        self.image_rows += video.shape[0]
        v = normalize_video(video, dtype=self.model.dtype)
        return self.model.encode_image(v)

    def _txt(self, text: torch.Tensor) -> torch.Tensor:
        self.text_calls += 1
        self.text_rows += text.shape[0]
        return self.model.encode_text(text.long())

    def encode_images(self, videos: np.ndarray) -> np.ndarray:
        """uint8 [N, T, H, W, 3] -> [N, D] f32 unit embeddings."""
        return self._sweep(self._img, videos)

    def encode_texts(self, texts: np.ndarray) -> np.ndarray:
        """int token ids [N, L] -> [N, D] f32 unit embeddings."""
        return self._sweep(self._txt, texts)

    def logit_scale(self) -> float:
        return float(self.model.logit_scale.detach().float().cpu())

    def batches(self, loader):
        """Iterate ``loader``, adding the wait for each batch to
        ``data_wait_s``."""
        it = iter(loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            finally:
                self.data_wait_s += time.perf_counter() - t0
            yield batch

    def sweep_loader(self, loader) -> Dict[str, np.ndarray]:
        """Iterate a loader, encoding its videos and texts; returns stacked
        embeddings plus any passthrough fields."""
        img, txt, extras = [], [], {}
        for batch in self.batches(loader):
            if "video" in batch:
                img.append(self.encode_images(batch["video"]))
            if "text" in batch:
                txt.append(self.encode_texts(batch["text"]))
            for k, v in batch.items():
                if k not in ("video", "text"):
                    extras.setdefault(k, []).append(np.asarray(v))
        out = {}
        if img:
            out["image_embed"] = np.concatenate(img)
        if txt:
            out["text_embed"] = np.concatenate(txt)
        for k, v in extras.items():
            out[k] = np.concatenate(v)
        return out


def build_text_classifier(
        encoders: CLIPEncoders, labels: Sequence[str],
        templates: Sequence[str] = tuple(ZERO_SHOT_TEMPLATES),
        context_length: int = 77) -> np.ndarray:
    """Prompt-ensemble classifier weights [n_classes, D]: every
    template-filled label encoded in one sweep, the mean over each label's
    templates, renormalized.  The JAX package encodes one label at a time;
    rows are independent, so the weights are the same."""
    prompts = [t.format(label) for label in labels for t in templates]
    emb = encoders.encode_texts(tokenize(prompts, context_length))
    mean = emb.reshape(len(labels), len(templates), -1).mean(axis=1)
    return mean / np.maximum(np.linalg.norm(mean, axis=-1, keepdims=True),
                             1e-8)


def validate_mir(encoders: CLIPEncoders, loader, relevancy_matrix: np.ndarray,
                 video_id_order: Optional[Sequence] = None,
                 text_id_order: Optional[Sequence] = None
                 ) -> Dict[str, float]:
    """EK100-MIR retrieval: similarity (x+1)/2, columns remapped from clip
    order to sentence order, then mAP and nDCG."""
    res = encoders.sweep_loader(loader)
    img, txt = res["image_embed"], res["text_embed"]
    n = relevancy_matrix.shape[0]
    img, txt = img[:n], txt[:n]
    sim = (img @ txt.T + 1) / 2
    if video_id_order is not None and text_id_order is not None:
        first: Dict = {}  # list.index semantics: the first occurrence
        for i, v in enumerate(video_id_order):
            first.setdefault(v, i)
        sim = sim[:, [first[t] for t in text_id_order]]
    vmap, tmap, amap = get_map(sim, relevancy_matrix)
    vndcg, tndcg, andcg = get_ndcg(sim, relevancy_matrix)
    return {
        "vis_map": vmap, "txt_map": tmap, "avg_map": amap,
        "vis_ndcg": vndcg, "txt_ndcg": tndcg, "avg_ndcg": andcg,
    }


def validate_zeroshot_cls(encoders: CLIPEncoders, loader,
                          classifier: np.ndarray, *,
                          n_classes: Optional[int] = None,
                          multilabel: bool = False,
                          marginal_actions=None) -> Dict[str, float]:
    """Zero-shot classification over a video loader.  Batches may carry
    several clips / crops per sample ([B, V, T, H, W, C]); logits are
    max-pooled over the views."""
    all_logits, all_labels = [], []
    for batch in encoders.batches(loader):
        video = batch["video"]
        if video.ndim == 6:  # views
            b, v = video.shape[:2]
            emb = encoders.encode_images(
                video.reshape((b * v,) + video.shape[2:]))
            logits = (emb @ classifier.T).reshape(b, v, -1).max(axis=1)
        else:
            logits = encoders.encode_images(video) @ classifier.T
        all_logits.append(logits)
        all_labels.append(np.asarray(batch["label"]))
    logits = np.concatenate(all_logits)
    labels = np.concatenate(all_labels)

    out: Dict[str, float] = {}
    if multilabel:
        m_ap, _, _ = charades_map(logits, labels)
        out["mAP"] = 100.0 * m_ap
        return out
    acc1, acc5 = topk_accuracy(logits, labels, (1, 5))
    out["acc1"], out["acc5"] = acc1, acc5
    if n_classes:
        cm = confusion_matrix(np.argmax(logits, 1), labels, n_classes)
        out["mean_class_acc"] = mean_class_accuracy(cm)[0]
    if marginal_actions is not None:
        # verb / noun marginals of the action probabilities
        probs = _softmax(logits)
        for mode in ("verb", "noun"):
            idx = get_marginal_indexes(marginal_actions, mode)
            mp = marginalize(probs, idx)
            col = 0 if mode == "verb" else 1
            part_labels = np.asarray([marginal_actions[a][col]
                                      for a in labels])
            out[f"{mode}_acc1"] = topk_accuracy(mp, part_labels, (1,))[0]
    return out


def validate_egomcq(encoders: CLIPEncoders, loader) -> Dict[str, float]:
    """EgoMCQ: each text query against its 5 candidate clips."""
    preds, answers, types = [], [], []
    for batch in encoders.batches(loader):
        q = encoders.encode_texts(batch["query"])  # [B, D]
        vids = batch["videos"]  # [B, 5, T, H, W, C]
        b, k = vids.shape[:2]
        v = encoders.encode_images(vids.reshape((b * k,) + vids.shape[2:]))
        preds.append(np.einsum("bd,bkd->bk", q, v.reshape(b, k, -1)))
        answers.append(np.asarray(batch["answer"]))
        types.append(np.asarray(batch["type"]))
    return egomcq_accuracy(np.concatenate(preds), np.concatenate(answers),
                           np.concatenate(types))


def _softmax(x):
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def validate_all(encoders: CLIPEncoders, suites: Dict[str, Callable],
                 strict: bool = False) -> Dict[str, float]:
    """Run each configured suite (a callable of ``encoders`` returning a
    metric dict); results are flattened to ``test_<suite>_<metric>``.

    With ``strict`` (standalone eval) a failing suite raises; inside a
    training run a failure prints its traceback and gives a
    ``test_<suite>_error`` sentinel, so that a misconfigured suite never
    passes for one that is not configured.  Each suite's wall time and
    the changes of the encoders' counters go to
    ``encoders.suite_stats``."""
    out = {}
    for name, fn in suites.items():
        before, t0 = encoders.counters(), time.perf_counter()
        try:
            metrics = fn(encoders)
        except Exception:
            if strict:
                raise
            print(f"[validate_all] suite {name} FAILED:\n"
                  f"{traceback.format_exc()}")
            out[f"test_{name}_error"] = 1.0
            continue
        finally:
            encoders.suite_stats[name] = {
                "wall_s": time.perf_counter() - t0,
                **{k: v - before[k] for k, v in encoders.counters().items()}}
        for k, v in metrics.items():
            out[f"test_{name}_{k}"] = float(v)
    return out
