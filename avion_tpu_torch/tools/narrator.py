"""Pseudo-narration generation, the LaViLa-narrator stage
(``avion_tpu.tools.narrator``): run a captioning model over fixed windows
of unlabeled video and write the training pkl of the pretraining entry,
rows of ``(video_id, start_sec, end_sec, [narrations])``.

The captioner is any ``caption_fn(frames: np.ndarray) -> List[str]`` over
a [T, H, W, 3] uint8 clip:

- :func:`vclm_captioner`: the port's VCLM (``models.narrator``), a bf16
  inference copy, the CLIP tokenizer, nucleus samples of up to 30 tokens;
- :func:`lavila_captioner`: the LaViLa narrator (``models.lavila``) from
  a released checkpoint, or an injected model, with GPT-2's tokenizer
  (``transformers``, which must be installed with its vocabulary unless a
  tokenizer is passed in);
- :func:`hf_captioner`: a HuggingFace image-to-text pipeline (needs
  ``transformers`` and the weights on disk).

Sampling draws from a ``torch.Generator`` seeded with ``seed``.  The
captioners run on CUDA unless they are given a model on the CPU (or
``device="cpu"``); without CUDA the default device raises.
"""

from __future__ import annotations

import os.path as osp
import pickle
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from avion_tpu_torch.data.sampling import get_frame_ids
from avion_tpu_torch.data.video_reader import CropSpec, VideoReader
from avion_tpu_torch.parallel.launch import resolve_device


def narrate_video(
    path: str,
    caption_fn: Callable[[np.ndarray], List[str]],
    *,
    window_sec: float = 4.0,
    stride_sec: float = 2.0,
    clip_length: int = 4,
    crop_size: int = 224,
    dedup_threshold: float = 0.9,
) -> List[Tuple[float, float, List[str]]]:
    """Slide a window over one video; returns (start, end, narrations) per
    window, a window whose first caption overlaps the previous one's by at
    least ``dedup_threshold`` merged into it."""
    vr = VideoReader(path)
    try:
        fps = vr.get_avg_fps() or 30.0
        duration = len(vr) / fps
        out: List[Tuple[float, float, List[str]]] = []
        t = 0.0
        prev: Optional[List[str]] = None
        while t < duration:
            end = min(t + window_sec, duration)
            ids = get_frame_ids(int(t * fps), int(end * fps),
                                num_segments=clip_length, jitter=False)
            frames = vr.get_batch(ids, CropSpec(), (crop_size, crop_size))
            caps = caption_fn(frames)
            if (prev is not None and caps and prev
                    and _overlap(caps[0], prev[0]) >= dedup_threshold):
                s0, _, caps0 = out[-1]
                out[-1] = (s0, end, caps0)
            else:
                out.append((t, end, caps))
            prev = caps
            t += stride_sec
    finally:
        vr.close()
    return out


def _overlap(a: str, b: str) -> float:
    ta, tb = set(a.lower().split()), set(b.lower().split())
    if not ta or not tb:
        return 0.0
    return len(ta & tb) / len(ta | tb)


def narrate_dataset(video_paths: Sequence[str], caption_fn, output_pkl: str,
                    **kwargs) -> int:
    """Write the pretraining pkl of every window of ``video_paths``: rows
    of (video_id, start_sec, end_sec, [narrations]); returns the row
    count."""
    rows = []
    for path in video_paths:
        vid = osp.splitext(osp.basename(path))[0]
        for start, end, caps in narrate_video(path, caption_fn, **kwargs):
            rows.append((vid, start, end, caps))
    with open(output_pkl, "wb") as f:
        pickle.dump(rows, f)
    return len(rows)


def _inference_copy(model: torch.nn.Module) -> torch.nn.Module:
    """The model in eval mode with its matrices pre-cast to bf16
    (``eval.runners.cast_inference_params``, in place: the same outputs,
    half the weight reads a decode step makes)."""
    from avion_tpu_torch.eval.runners import cast_inference_params

    return cast_inference_params(model).eval()


def _clip_input(frames: np.ndarray, model, device) -> torch.Tensor:
    from avion_tpu_torch.data.transforms import normalize_video

    video = torch.from_numpy(np.array(frames, np.uint8))[None].to(device)
    return normalize_video(video, dtype=model.dtype)


def vclm_captioner(model, *, num_samples: int = 3, max_len: int = 30,
                   top_p: float = 0.95, temperature: float = 0.7,
                   seed: int = 0):
    """A ``caption_fn`` over the port's VCLM (``models.narrator``), on the
    model's device: each call generates ``num_samples`` narrations of up to
    ``max_len`` tokens (a generation each, drawn from one
    ``torch.Generator`` seeded with ``seed``) and decodes them with the
    CLIP tokenizer, SOT, EOT and padding dropped.  The model becomes its
    own bf16 inference copy."""
    from avion_tpu_torch.data.tokenizer import _default_tokenizer
    from avion_tpu_torch.models.narrator import make_generator

    model = _inference_copy(model)
    device = next(model.parameters()).device
    tk = _default_tokenizer()
    gen = make_generator(model, max_len=max_len, top_p=top_p,
                         temperature=temperature, sot=tk.sot_token,
                         eot=tk.eot_token)
    generator = torch.Generator(device).manual_seed(seed)

    def caption(frames: np.ndarray) -> List[str]:
        video = _clip_input(frames, model, device)
        outs = []
        for _ in range(num_samples):
            toks = gen(video, generator)[0].tolist()
            ids = [t for t in toks[1:]
                   if t not in (0, tk.sot_token, tk.eot_token)]
            outs.append(tk.decode(ids).strip())
        return outs

    return caption


def hf_captioner(model_name: str = "Salesforce/blip2-opt-2.7b",
                 num_samples: int = 3, device: str = "cuda"):
    """A ``caption_fn`` over a HuggingFace image-to-text checkpoint, on the
    clip's middle frame (needs ``transformers`` and the weights on disk),
    on CUDA unless ``device="cpu"``: the device is resolved before
    ``transformers`` is imported, so without CUDA it raises before it loads
    anything."""
    device = resolve_device(device)
    from transformers import pipeline  # gated import

    pipe = pipeline("image-to-text", model=model_name, device=device)

    def caption(frames: np.ndarray) -> List[str]:
        from PIL import Image

        mid = Image.fromarray(frames[len(frames) // 2])
        outs = pipe(mid, generate_kwargs={
            "do_sample": True, "top_p": 0.95,
            "num_return_sequences": num_samples,
        })
        return [o["generated_text"].strip() for o in outs]

    return caption


def gpt2_tokenizer():
    """GPT-2's BPE tokenizer (``transformers.GPT2Tokenizer``, with the
    ``gpt2`` vocabulary on disk); raises where ``transformers`` is not
    installed."""
    try:
        from transformers import GPT2Tokenizer
    except ImportError as e:
        raise ImportError(
            "lavila_captioner needs GPT-2's tokenizer: install transformers "
            "with the gpt2 vocabulary, or pass tokenizer=...") from e
    return GPT2Tokenizer.from_pretrained("gpt2")


def lavila_captioner(checkpoint: Optional[str] = None, *,
                     model_name: str =
                     "VCLM_OPENAI_TIMESFORMER_LARGE_336PX_GPT2_XL",
                     num_frames: int = 4, num_samples: int = 3,
                     max_len: int = 77, top_p: float = 0.95,
                     temperature: float = 0.7, seed: int = 0,
                     model=None, tokenizer=None, device: str = "cuda"):
    """A ``caption_fn`` over the LaViLa narrator proper
    (``models.lavila.LavilaNarrator``), on the model's device: ``model``
    as given (with its weights; tests pass a tiny one), else
    ``model_name`` built on ``device``; a released ``checkpoint`` is
    loaded into it (``models.lavila_import``, strict).  The prompt is
    GPT-2's BOS (= EOS); each generation is cut at the first EOS after it
    and decoded by ``tokenizer`` (``decode`` and ``eos_token_id``; by
    default :func:`gpt2_tokenizer`).  The model becomes its own bf16
    inference copy."""
    from avion_tpu_torch.models.lavila_import import load_lavila_narrator

    if model is None:
        from avion_tpu_torch.models.registry import create_model

        if not checkpoint:
            raise ValueError("need checkpoint=... or model=...")
        with torch.device("meta"):
            model = create_model(model_name, num_frames=num_frames)
        model = model.to_empty(device=resolve_device(device))
    if checkpoint:
        load_lavila_narrator(model, checkpoint)
    if tokenizer is None:
        tokenizer = gpt2_tokenizer()
    bos = getattr(tokenizer, "eos_token_id", 50256)  # GPT-2: BOS == EOS
    model = _inference_copy(model)
    dev = next(model.parameters()).device
    generator = torch.Generator(dev).manual_seed(seed)
    prompt = torch.full((1, 1), bos, dtype=torch.long, device=dev)

    def caption(frames: np.ndarray) -> List[str]:
        video = _clip_input(frames, model, dev)
        outs = []
        for _ in range(num_samples):
            ids = model.generate(video, prompt, max_len=max_len,
                                 temperature=temperature, top_p=top_p,
                                 generator=generator)[0].tolist()
            # strip the BOS prompt; cut at the first EOS after it
            ids = ids[1:]
            if bos in ids:
                ids = ids[:ids.index(bos)]
            outs.append(tokenizer.decode(ids).strip())
        return outs

    return caption
