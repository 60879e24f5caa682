"""Embedding sweeps, the zero-shot text classifier and the suites' runners
(``avion_tpu.eval.runners``).

Eager PyTorch compiles nothing per shape, so :class:`CLIPEncoders`
chunks inputs at ``batch`` rows WITHOUT padding the last chunk to a static
size (the JAX runner pads so that XLA compiles once); rows are
independent, so the embeddings are the same.  For the same reason there is
no ``CLIPEncoders.cached``: the JAX package keeps encoders across
validation epochs only so as not to recompile both towers.

The encoders cast or quantize the model they are given
(:func:`cast_inference_params` and :func:`quantize_inference_params` work
in place) and switch it to eval mode; a training run therefore evaluates a
copy (``eval.validate.run_validation``).

Over several ``devices`` (the server's ``--mesh``) one process drives one
model copy per device, each from a persistent worker thread of its own:
each chunk is padded with its last row to a multiple of the replicas, row
block r goes to replica r, and the embeddings come back in row order, as
the JAX runner shards a batch over the data axes of a one-process mesh.

Over a batch group of several ranks (``group``) every rank walks the whole
eval set, encodes its block of each chunk (the chunk padded with its last
row to a multiple of the ranks) and the embeddings are all-gathered, as the
JAX runner feeds each process its rows of a chunk; the ``sp`` ranks of a
group encode the same rows, each its shard of the tokens.
"""

from __future__ import annotations

import contextlib
import copy
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

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
# temporal and token embeddings) and the MoE router (rounding would flip its
# discrete top-k); rounding them early would change outputs
_CAST_EXCLUDE = ("positional", "temporal", "token_embedding", "pos_embed",
                 "wte", "wpe", "router")
WEIGHT_DTYPES = ("bf16", "int8", "f32")


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


def _skips_quantization(name: str, p: torch.Tensor) -> bool:
    return (any(k in name.lower() for k in _CAST_EXCLUDE) or p.dim() < 2
            or p.dtype not in (torch.float32, torch.bfloat16))


def _channel_dim(module: torch.nn.Module) -> int:
    """The output channel of a parameter owned by ``module``: dim 0 of a
    dense or patchify weight (``[out, in, ...]``, the reference's torch
    layout), the last dim of a bare matrix used as ``x @ w`` (the
    projections), as JAX takes the last axis of its ``[in, out]``
    kernels."""
    from avion_tpu_torch.models.vit import PatchEmbed

    return 0 if isinstance(module, (torch.nn.Linear, PatchEmbed)) else -1


def dequantize_params(q: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """The weight rebuilt from its int8 values and f32 scales:
    ``(q * scale)`` in f32, then cast to the compute ``dtype``."""
    return (q.float() * scale).to(dtype)


class _Dequantize(torch.nn.Module):
    """The parametrization of one quantized weight: the module keeps the
    int8 tensor (``parametrizations.<name>.original``) and this its f32
    scales; each access rebuilds that one weight in the compute dtype."""

    def __init__(self, scale: torch.Tensor, dtype: torch.dtype):
        super().__init__()
        self.register_buffer("scale", scale)
        self.dtype = dtype

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        return dequantize_params(q, self.scale, self.dtype)


@torch.no_grad()
def quantize_inference_params(model: torch.nn.Module
                              ) -> Dict[str, tuple]:
    """Weight-only int8 quantization of the matrix parameters, in place:
    per output channel (:func:`_channel_dim`) ``s = max|w| / 127`` over
    the other dims, floored at 1e-12, and ``q = clip(round(w / s), -127,
    127)`` in f32 (round half to even, as numpy).  The parameters that
    :func:`cast_inference_params` keeps f32 stay as they are.  Each
    quantized weight becomes a parametrization (:class:`_Dequantize`), so
    the model holds int8 values and f32 scales and never a full copy in
    the compute dtype: a forward rebuilds one layer's weight at a time.
    Lossy (about 0.4% a weight), so for serving only (``--weights
    int8``).  Returns ``{name: (q, scale)}`` of the quantized
    parameters."""
    from torch.nn.utils import parametrize

    out = {}
    targets = [(name, *_owner(model, name))
               for name, p in model.named_parameters()
               if not _skips_quantization(name, p)]
    for name, module, leaf in targets:
        w = getattr(module, leaf).detach().float()
        dim = _channel_dim(module) % w.dim()
        other = tuple(d for d in range(w.dim()) if d != dim)
        scale = (w.abs().amax(dim=other, keepdim=True) / 127.0).clamp_min(
            1e-12)
        q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
        setattr(module, leaf, torch.nn.Parameter(q, requires_grad=False))
        parametrize.register_parametrization(
            module, leaf, _Dequantize(scale, model.dtype), unsafe=True)
        out[name] = (q, scale)
    return out


def _owner(model: torch.nn.Module, name: str):
    *path, leaf = name.split(".")
    return model.get_submodule(".".join(path)), leaf


def weight_bytes(model: torch.nn.Module) -> int:
    """Bytes of the model's parameters and buffers (int8 values and their
    scales, where quantized)."""
    return sum(t.numel() * t.element_size()
               for t in [*model.parameters(), *model.buffers()])


_CALL_COUNTERS = ("image_calls", "text_calls", "image_rows", "text_rows")


class CLIPEncoders:
    """Batched encode functions over a CLIP model on one device, or over
    one copy of it on each of ``devices``.

    ``weight_dtype``: ``bf16`` pre-casts the matrices
    (:func:`cast_inference_params`), ``int8`` quantizes them
    (:func:`quantize_inference_params`), ``f32`` keeps them.  Without
    ``devices`` the model stays where it is; with them, the copies are
    made on the host, prepared there and moved, the given model becoming
    the first replica, and ``batch`` is rounded up to a multiple of the
    replicas (the JAX runner's rounding to the mesh's batch shards).
    Every call enters ``torch.inference_mode()`` and its replica's CUDA
    device itself: both are thread-local, and the server calls from its
    batcher threads.

    Counters: tower forwards (``image_calls`` / ``text_calls``, one per
    replica and chunk; served as /metrics 'encoder'), rows encoded
    (``image_rows`` / ``text_rows``, pad rows included), each summed over
    the replicas (``replica_counters`` keeps them by replica), seconds
    spent waiting for a loader's next batch (``data_wait_s``), and per
    suite of :func:`validate_all` the changes of these with the suite's
    wall time (``suite_stats``).
    """

    def __init__(self, model, batch: int = 64, weight_dtype: str = "bf16",
                 group=None, devices: Optional[Sequence] = None):
        if weight_dtype not in WEIGHT_DTYPES:
            raise ValueError(f"weight_dtype must be bf16|int8|f32, got "
                             f"{weight_dtype!r}")
        replicas = [model]
        if devices is not None:
            replicas += [copy.deepcopy(model) for _ in devices[1:]]
        for m in replicas:
            if weight_dtype == "bf16":
                cast_inference_params(m)
            elif weight_dtype == "int8":
                quantize_inference_params(m)
            m.eval()
        if devices is not None:
            replicas = [m.to(d) for m, d in zip(replicas, devices)]
        self.model = replicas[0]
        self.replicas: List[torch.nn.Module] = replicas
        self.devices = [next(m.parameters()).device for m in replicas]
        self.device = self.devices[0]
        self.weight_dtype = weight_dtype
        self.batch = -(-batch // len(replicas)) * len(replicas)
        self.group = (group if group is not None and dist.is_initialized()
                      and dist.get_world_size(group) > 1 else None)
        if self.group is not None and len(replicas) > 1:
            raise ValueError("replicas and a process group do not combine")
        self._lock = threading.Lock()
        self.replica_counters = [dict.fromkeys(_CALL_COUNTERS, 0)
                                 for _ in replicas]
        # one persistent thread per replica; a single replica runs inline
        self._workers = ([ThreadPoolExecutor(1, f"replica{r}")
                          for r in range(len(replicas))]
                         if len(replicas) > 1 else [])
        self.data_wait_s = 0.0
        self.suite_stats: Dict[str, Dict[str, float]] = {}

    def _total(self, key: str) -> int:
        with self._lock:
            return sum(c[key] for c in self.replica_counters)

    image_calls = property(lambda self: self._total("image_calls"))
    text_calls = property(lambda self: self._total("text_calls"))
    image_rows = property(lambda self: self._total("image_rows"))
    text_rows = property(lambda self: self._total("text_rows"))

    def counters(self) -> Dict[str, float]:
        return {**{k: self._total(k) for k in _CALL_COUNTERS},
                "data_wait_s": self.data_wait_s}

    def replica_metrics(self) -> List[dict]:
        """Each replica's device, weight bytes and counters."""
        with self._lock:
            counts = [dict(c) for c in self.replica_counters]
        return [{"device": str(d), "weight_bytes": weight_bytes(m), **c}
                for d, m, c in zip(self.devices, self.replicas, counts)]

    def close(self) -> None:
        for w in self._workers:
            w.shutdown(wait=True)

    def _context(self, r: int = 0):
        stack = contextlib.ExitStack()
        stack.enter_context(torch.inference_mode())
        if self.devices[r].type == "cuda":
            stack.enter_context(torch.cuda.device(self.devices[r]))
        return stack

    def _sweep(self, fn, arr: np.ndarray) -> np.ndarray:
        out = []
        if self._workers:
            for i in range(0, arr.shape[0], self.batch):
                out.append(self._encode_replicated(
                    fn, arr[i : i + self.batch]))
            return np.concatenate(out, axis=0)
        with self._context():
            for i in range(0, arr.shape[0], self.batch):
                chunk = torch.from_numpy(np.ascontiguousarray(
                    arr[i : i + self.batch])).to(self.device)
                out.append(self._encode_shared(fn, chunk).float().cpu()
                           .numpy())
        return np.concatenate(out, axis=0)

    def _encode_replicated(self, fn, chunk: np.ndarray) -> np.ndarray:
        """``fn`` of ``chunk``: its rows padded with the last to a multiple
        of the replicas, block r encoded by replica r on its own thread,
        concatenated in row order."""
        n, rows = len(self.replicas), chunk.shape[0]
        per = -(-rows // n)
        padded = chunk[np.minimum(np.arange(per * n), rows - 1)]
        futs = [w.submit(self._encode_block, fn, r,
                         padded[r * per : (r + 1) * per])
                for r, w in enumerate(self._workers)]
        return np.concatenate([f.result() for f in futs])[:rows]

    def _encode_block(self, fn, r: int, block: np.ndarray) -> np.ndarray:
        with self._context(r):
            x = torch.from_numpy(np.ascontiguousarray(block)).to(
                self.devices[r])
            return fn(x, r).float().cpu().numpy()

    def _encode_shared(self, fn, chunk: torch.Tensor) -> torch.Tensor:
        """``fn`` of ``chunk``; over a group, of this rank's block of it,
        gathered."""
        if self.group is None:
            return fn(chunk)
        n, rank = dist.get_world_size(self.group), dist.get_rank(self.group)
        rows = chunk.shape[0]
        per = -(-rows // n)
        pad = chunk[-1:].expand(per * n - rows, *chunk.shape[1:])
        mine = torch.cat([chunk, pad])[rank * per:(rank + 1) * per]
        emb = fn(mine).contiguous()
        parts = [torch.empty_like(emb) for _ in range(n)]
        dist.all_gather(parts, emb, group=self.group)
        return torch.cat(parts)[:rows]

    def _bump(self, r: int, calls: str, rows: str, n: int) -> None:
        with self._lock:
            self.replica_counters[r][calls] += 1
            self.replica_counters[r][rows] += n

    def _img(self, video: torch.Tensor, r: int = 0) -> torch.Tensor:
        self._bump(r, "image_calls", "image_rows", video.shape[0])
        model = self.replicas[r]
        return model.encode_image(normalize_video(video, dtype=model.dtype))

    def _txt(self, text: torch.Tensor, r: int = 0) -> torch.Tensor:
        self._bump(r, "text_calls", "text_rows", text.shape[0])
        return self.replicas[r].encode_text(text.long())

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


class _Rows:
    """The items of ``dataset`` at ``rows``, in order."""

    def __init__(self, dataset, rows: np.ndarray):
        self.dataset, self.rows = dataset, rows

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, i: int):
        return self.dataset[int(self.rows[i])]


def block_rows(n_rows: int, rank: int, n: int) -> np.ndarray:
    """Rank ``rank``'s block of ``n_rows`` rows over ``n`` ranks: ceil(n_rows
    / n) consecutive rows, the last block padded with the last row."""
    per = -(-n_rows // n)
    return np.minimum(np.arange(rank * per, (rank + 1) * per), n_rows - 1)


@torch.no_grad()
def multi_view_probs(fn: Callable[[torch.Tensor], torch.Tensor], dataset,
                     batch: int, num_workers: int, device: torch.device,
                     group=None):
    """The multi-view test's scores: (probs [N, classes] f32, labels [N])
    of every item of ``dataset`` (``video`` [views, T, H, W, C] or [T, H, W,
    C], ``label``), ``fn(video [rows * views, T, H, W, C] uint8 on
    ``device``) -> logits``, the softmax averaged over each item's views.
    Over a ``group`` of n ranks each rank scores its block of the items
    (:func:`block_rows`), ``batch`` rows a call, so every rank calls ``fn``
    as often; the blocks are gathered in rank order, which is row order."""
    from avion_tpu_torch.data.loader import DataLoader

    n_rows = len(dataset)
    rank, n = ((dist.get_rank(group), dist.get_world_size(group))
               if group is not None and dist.is_initialized() else (0, 1))
    if n > 1:
        dataset = _Rows(dataset, block_rows(n_rows, rank, n))
    loader = DataLoader(dataset, batch, shuffle=False, drop_last=False,
                        num_workers=num_workers)
    probs, labels = [], []
    try:
        for b in loader:
            video = torch.from_numpy(b["video"]).to(device)
            views = video.shape[1] if video.dim() == 6 else 1
            video = video.reshape((-1,) + video.shape[-4:])
            p = torch.softmax(fn(video).float(), dim=-1)
            probs.append(p.reshape(-1, views, p.shape[-1]).mean(dim=1))
            labels.append(torch.as_tensor(np.asarray(b["label"]),
                                          device=device))
    finally:
        loader.close()
    probs, labels = torch.cat(probs), torch.cat(labels).long()
    if n > 1:
        parts = [torch.empty_like(probs) for _ in range(n)]
        dist.all_gather(parts, probs.contiguous(), group=group)
        probs = torch.cat(parts)[:n_rows]
        parts = [torch.empty_like(labels) for _ in range(n)]
        dist.all_gather(parts, labels.contiguous(), group=group)
        labels = torch.cat(parts)[:n_rows]
    return probs.cpu().numpy(), labels.cpu().numpy()
