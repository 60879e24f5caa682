"""LLM narration refinement pipeline (offline dataset factory) (the port's
copy of ``avion_tpu.tools.narration_refinement``).

Counterpart of ``second_party/qwen3vl/vllm_refine.py`` + the merge
scripts (``merge_results.py``): re-localize caption temporal boundaries
within chunked video using a vision-language LLM, then rebuild the
training pkl.  The LLM call is pluggable — the reference drives a vLLM
server with Qwen3-VL; here any callable ``infer(frames, caption) ->
{"start": s, "end": e, "caption": str}`` works (an OpenAI-compatible
HTTP endpoint, a local transformers pipeline, ...), so the data-side
logic is testable without model weights.

The refinement prompt contract (``vllm_refine.py:30-58``): the model
sees uniformly sampled frames of a window around the annotated clip and
must return tightened boundaries + optionally a rewritten caption.
"""

from __future__ import annotations

import json
import os.path as osp
import pickle
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

REFINE_PROMPT = (
    "You are given {n} frames uniformly sampled from a {window:.0f}-second "
    "egocentric video window. The annotated narration is: \"{caption}\" "
    "with annotated span [{start:.1f}s, {end:.1f}s] inside this window. "
    "Return JSON {{\"start\": <sec>, \"end\": <sec>, \"caption\": <str>}} "
    "with the tightest span in which the narrated action is visible."
)


@dataclass
class RefineItem:
    vid: str
    start: float
    end: float
    caption: str
    window_start: float = 0.0
    window_end: float = 0.0


def build_refine_items(samples: Sequence, window_pad: float = 7.5) -> List[RefineItem]:
    """Expand each (vid, start, end, caption) row with a padded context
    window (the reference works on 15-second chunk windows)."""
    items = []
    for row in samples:
        vid, start, end, caption = row[0], float(row[1]), float(row[2]), row[3]
        if isinstance(caption, list):
            caption = caption[0] if caption else ""
        items.append(RefineItem(
            vid=vid, start=start, end=end, caption=str(caption),
            window_start=max(0.0, start - window_pad),
            window_end=end + window_pad,
        ))
    return items


def refine_samples(
    items: Sequence[RefineItem],
    infer: Callable[[RefineItem], Optional[dict]],
    *,
    reject_outside_window: bool = True,
) -> List[dict]:
    """Run the pluggable LLM on each item; sanitize outputs (clamp into
    the window, drop inverted spans) like the merge scripts do."""
    results = []
    for i, item in enumerate(items):
        out = None
        try:
            out = infer(item)
        except Exception:
            out = None
        rec = {"index": i, "vid": item.vid, "orig_start": item.start,
               "orig_end": item.end, "caption": item.caption,
               "refined": False}
        if out and "start" in out and "end" in out:
            s, e = float(out["start"]), float(out["end"])
            if reject_outside_window:
                s = max(item.window_start, min(s, item.window_end))
                e = max(item.window_start, min(e, item.window_end))
            if e > s:
                rec.update(start=s, end=e, refined=True,
                           caption=out.get("caption", item.caption))
        if not rec["refined"]:
            rec.update(start=item.start, end=item.end)
        results.append(rec)
    return results


def temporal_iou(a: Tuple[float, float], b: Tuple[float, float]) -> float:
    """IoU of two [start, end] spans
    (``merge_results_multiple_responses.py:135-163``)."""
    inter = max(0.0, min(a[1], b[1]) - max(a[0], b[0]))
    union = max(a[1], b[1]) - min(a[0], b[0])
    return inter / union if union > 0 else 0.0


def cluster_spans(spans: Sequence[Tuple[float, float]],
                  distance_threshold: float = 0.1) -> List[int]:
    """Average-linkage agglomerative clustering on the 1-IoU distance
    (the reference's sklearn AgglomerativeClustering with precomputed
    metric, ``merge_results_multiple_responses.py:304-313``) — clusters
    merge while their average pairwise distance stays below the
    threshold.  Returns a label per span."""
    n = len(spans)
    dist = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            dist[i, j] = dist[j, i] = 1.0 - temporal_iou(spans[i], spans[j])
    clusters: List[List[int]] = [[i] for i in range(n)]
    while len(clusters) > 1:
        best, bi, bj = None, -1, -1
        for i in range(len(clusters)):
            for j in range(i + 1, len(clusters)):
                d = float(np.mean([dist[a, b] for a in clusters[i]
                                   for b in clusters[j]]))
                if best is None or d < best:
                    best, bi, bj = d, i, j
        if best is None or best >= distance_threshold:
            break
        clusters[bi] = clusters[bi] + clusters[bj]
        del clusters[bj]
    labels = [0] * n
    for c, members in enumerate(clusters):
        for m in members:
            labels[m] = c
    return labels


def merge_multi_responses(
    item: RefineItem,
    candidates: Sequence[Optional[dict]],
    *,
    distance_threshold: float = 0.1,
) -> dict:
    """Consensus over N sampled refinements for one caption
    (``merge_results_multiple_responses.py:270-340``): keep valid spans
    (start < end, non-negative), cluster by temporal IoU, take the
    majority cluster's centroid.  Fewer than two valid responses falls
    back to the original span.  The caption stays the original (the
    reference's multi-response merge refines boundaries only)."""
    spans = []
    for out in candidates:
        if not out or "start" not in out or "end" not in out:
            continue
        try:
            s, e = float(out["start"]), float(out["end"])
        except (TypeError, ValueError):
            continue
        if s < 0 or e < 0 or s > e:
            continue
        spans.append((s, e))
    rec = {"vid": item.vid, "orig_start": item.start, "orig_end": item.end,
           "caption": item.caption, "n_valid": len(spans), "refined": False}
    if len(spans) < 2:
        rec.update(start=item.start, end=item.end)
        return rec
    labels = cluster_spans(spans, distance_threshold)
    counts: Dict[int, int] = {}
    for lab in labels:
        counts[lab] = counts.get(lab, 0) + 1
    major = max(counts, key=lambda k: counts[k])
    members = [spans[i] for i, lab in enumerate(labels) if lab == major]
    s = float(np.mean([m[0] for m in members]))
    e = float(np.mean([m[1] for m in members]))
    s = max(item.window_start, s)
    e = min(item.window_end, e) if item.window_end > 0 else e
    if e > s:
        rec.update(start=s, end=e, refined=True,
                   n_majority=len(members))
    else:
        rec.update(start=item.start, end=item.end)
    return rec


def refine_samples_multi(
    items: Sequence[RefineItem],
    infer_multi: Callable[[RefineItem], Sequence[Optional[dict]]],
    *,
    distance_threshold: float = 0.1,
) -> List[dict]:
    """Multi-response variant of :func:`refine_samples`
    (``vllm_refine_multiple_captions.py`` samples n=10 candidates per
    caption at temperature 0.7; the merge votes by IoU clustering).
    ``infer_multi(item)`` returns a list of candidate dicts."""
    results = []
    for i, item in enumerate(items):
        try:
            candidates = list(infer_multi(item) or [])
        except Exception:
            candidates = []
        rec = merge_multi_responses(item, candidates,
                                    distance_threshold=distance_threshold)
        rec["index"] = i
        results.append(rec)
    return results


def merge_to_train_pkl(
    results: Sequence[dict],
    output_path: str,
    *,
    variant: str = "standard",
    scale: float = 1.0,
) -> int:
    """Rebuild a training pkl from refinement results
    (``merge_results.py`` variants: standard / scaled / keep-original).

    - standard: use refined spans where available
    - scaled: additionally scale refined spans around their center
    - original: keep original spans (control arm)
    """
    rows = []
    for r in results:
        s, e = r["start"], r["end"]
        if variant == "scaled" and r["refined"]:
            c, h = (s + e) / 2, (e - s) / 2 * scale
            s, e = max(0.0, c - h), c + h
        elif variant == "original":
            s, e = r["orig_start"], r["orig_end"]
        rows.append((r["vid"], s, e, r["caption"]))
    with open(output_path, "wb") as f:
        pickle.dump(rows, f)
    return len(rows)


def http_vlm_infer(endpoint: str, model: str = "Qwen/Qwen2-VL-7B-Instruct",
                   *, video_root: str = "", clip_length: int = 8,
                   crop_size: int = 336, timeout: float = 120.0):
    """Build an ``infer(item)`` against an OpenAI-compatible VLM server
    (the reference drives a vLLM server the same way,
    ``second_party/qwen3vl/vllm_refine.py``): frames are sampled from
    the item's context window, base64-embedded, and the model must
    answer with the JSON contract in ``REFINE_PROMPT``."""
    import base64
    import urllib.request

    from avion_tpu_torch.data.sampling import load_clip

    def infer(item: RefineItem) -> Optional[dict]:
        frames = load_clip(
            video_root, item.vid, "mp4", item.window_start, item.window_end,
            chunk_len=15, clip_length=clip_length,
            out_size=(crop_size, crop_size), jitter=False,
        )
        try:
            import cv2

            images = []
            for f in frames:
                ok, buf = cv2.imencode(".jpg", f[:, :, ::-1])
                if ok:
                    images.append(base64.b64encode(buf.tobytes()).decode())
        except ImportError:
            images = []
        prompt = REFINE_PROMPT.format(
            n=len(images), window=item.window_end - item.window_start,
            caption=item.caption, start=item.start - item.window_start,
            end=item.end - item.window_start,
        )
        content = [{"type": "text", "text": prompt}] + [
            {"type": "image_url",
             "image_url": {"url": f"data:image/jpeg;base64,{img}"}}
            for img in images
        ]
        payload = json.dumps({
            "model": model,
            "messages": [{"role": "user", "content": content}],
            "temperature": 0.0,
        }).encode()
        req = urllib.request.Request(
            f"{endpoint.rstrip('/')}/v1/chat/completions", data=payload,
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            reply = json.load(resp)
        return parse_vlm_reply(reply["choices"][0]["message"]["content"],
                               item)

    return infer


def parse_vlm_reply(text: str, item: RefineItem) -> Optional[dict]:
    """Extract the JSON contract from a model reply and convert the
    window-relative span to absolute seconds."""
    start = text.find("{")
    end = text.rfind("}")
    if start < 0 or end < 0:
        return None
    try:
        out = json.loads(text[start : end + 1])
        out["start"] = float(out["start"]) + item.window_start
        out["end"] = float(out["end"]) + item.window_start
    except (ValueError, KeyError, TypeError):
        return None
    return out


def local_vlm_infer(model_path: str, *, video_root: str = "",
                    clip_length: int = 8, crop_size: int = 336,
                    device: str = "cpu", max_new_tokens: int = 128):
    """Build an ``infer(item)`` over a LOCAL HuggingFace VLM checkpoint
    directory via transformers — the serverless counterpart of the
    reference's vLLM deployment (``vllm_refine.py``): same frame
    sampling, same prompt contract, greedy decoding, no network.

    ``model_path`` must hold a processor + an image-text-to-text model
    (e.g. a downloaded Qwen-VL snapshot)."""
    import torch
    from transformers import AutoModelForImageTextToText, AutoProcessor

    from avion_tpu_torch.data.sampling import load_clip

    processor = AutoProcessor.from_pretrained(model_path)
    model = AutoModelForImageTextToText.from_pretrained(model_path)
    model = model.to(device).eval()

    def infer(item: RefineItem) -> Optional[dict]:
        from PIL import Image

        frames = load_clip(
            video_root, item.vid, "mp4", item.window_start, item.window_end,
            chunk_len=15, clip_length=clip_length,
            out_size=(crop_size, crop_size), jitter=False,
        )
        images = [Image.fromarray(f) for f in frames]
        prompt = REFINE_PROMPT.format(
            n=len(images), window=item.window_end - item.window_start,
            caption=item.caption, start=item.start - item.window_start,
            end=item.end - item.window_start,
        )
        messages = [{"role": "user", "content":
                     [{"type": "image"} for _ in images]
                     + [{"type": "text", "text": prompt}]}]
        text = processor.apply_chat_template(messages,
                                             add_generation_prompt=True)
        inputs = processor(text=text, images=images, return_tensors="pt")
        inputs = {k: v.to(device) if hasattr(v, "to") else v
                  for k, v in inputs.items()}
        with torch.no_grad():
            out = model.generate(**inputs, max_new_tokens=max_new_tokens,
                                 do_sample=False)
        n_in = inputs["input_ids"].shape[1]
        reply = processor.batch_decode(out[:, n_in:],
                                       skip_special_tokens=True)[0]
        return parse_vlm_reply(reply, item)

    return infer


def make_json_line_writer(path: str):
    """Streaming result sink (vLLM batch jobs write JSONL)."""
    f = open(path, "a")

    def write(rec: dict):
        f.write(json.dumps(rec) + "\n")
        f.flush()

    return write
