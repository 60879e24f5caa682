"""Feature extraction for NLQ grounding with the dual encoder
(``avion_tpu.egonlq.features``).

Counterpart of the reference's ``egonlq/main.py:69-199``
(``fused_feature_extract``): slide a fixed window over the whole video,
encode each window with the visual tower and each query with the text
tower, and cache the features per sample as ``.npz``.

The features are the JAX extractor's: a window's is the visual tower's
pooled output through the CLIP's projection, ``embed_dim`` wide (512 for
``CLIP_VITB16``) and not L2-normalized (the JAX ``m.visual`` carries the
projection; the port's ``visual`` returns width features and the
projection is ``CLIP.image_projection``); a query's is ``encode_text``,
L2-normalized.  The model runs as its bf16 inference copy
(``eval.runners.cast_inference_params``), on its own device: on CUDA both
towers launch the flash inference kernel (the visual tower non-causal,
the text tower causal, one query at a time as the JAX loop encodes
them).
"""

from __future__ import annotations

import os
import os.path as osp
import time

import numpy as np
import torch

from avion_tpu_torch.data.sampling import get_frame_ids
from avion_tpu_torch.data.tokenizer import tokenize
from avion_tpu_torch.data.transforms import center_crop_spec, normalize_video
from avion_tpu_torch.data.video_reader import VideoReader
from avion_tpu_torch.eval.runners import cast_inference_params


def strip_projection(clip_model):
    """The width-feature visual tower of a CLIP (the reference nulls
    ``image_projection``, ``egonlq/main.py:101-108``): the port's
    ``VisionTransformer`` already stops before the projection, so this is
    ``clip_model.visual`` itself, sharing its weights."""
    return clip_model.visual


class FeatureExtractor:
    """Windowed video features and query features of a CLIP on its device.
    ``stats`` sums the seconds spent decoding and encoding, with the
    windows and queries done, and keeps each ``text_features`` call's ms
    (``query_ms``: the first call also loads the tokenizer)."""

    def __init__(self, model, *, clip_length: int = 4,
                 window_sec: float = 2.0, fps: float = 30.0,
                 crop_size: int = 224, batch: int = 32):
        self.model = self._prepare(model)
        self.clip_length = clip_length
        self.window_sec = window_sec
        self.fps = fps
        self.crop_size = crop_size
        self.batch = batch
        self.stats = {"windows": 0, "decode_s": 0.0, "encode_s": 0.0,
                      "queries": 0, "text_s": 0.0, "query_ms": []}

    @staticmethod
    def _prepare(model):
        # bf16 weight storage: exact for a bf16-compute model, and half the
        # weight bytes each window batch reads
        return cast_inference_params(model).eval()

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.inference_mode()
    def _vis(self, video: np.ndarray) -> np.ndarray:
        m = self.model
        v = normalize_video(torch.from_numpy(video).to(self.device),
                            dtype=m.dtype)
        pooled = m.visual(v)
        feats = pooled @ m.image_projection.to(pooled.dtype)
        return feats.float().cpu().numpy()

    @torch.inference_mode()
    def _txt(self, toks: np.ndarray) -> np.ndarray:
        text = torch.from_numpy(toks).long().to(self.device)
        return self.model.encode_text(text).float().cpu().numpy()

    def decode_windows(self, path: str) -> np.ndarray:
        """[W, T, H, W, C] uint8: ``clip_length`` frames of every
        ``window_sec`` window of the whole video, centre-cropped."""
        t0 = time.perf_counter()
        vr = VideoReader(path)
        n = len(vr)
        fps = vr.get_avg_fps() or self.fps
        win = max(1, int(self.window_sec * fps))
        crop = center_crop_spec(vr.width, vr.height)
        windows = []
        for start in range(0, n, win):
            ids = get_frame_ids(start, min(start + win, n),
                                num_segments=self.clip_length, jitter=False)
            windows.append(vr.get_batch(ids, crop,
                                        (self.crop_size, self.crop_size)))
        clips = np.stack(windows)
        self.stats["decode_s"] += time.perf_counter() - t0
        return clips

    def encode_windows(self, clips: np.ndarray) -> np.ndarray:
        """[W, D] f32 in batches of ``batch`` windows, the last batch padded
        by repeating its last window and cut back."""
        t0 = time.perf_counter()
        out = []
        for i in range(0, len(clips), self.batch):
            chunk = clips[i : i + self.batch]
            pad = 0
            if len(chunk) < self.batch:
                pad = self.batch - len(chunk)
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], pad, 0)], 0)
            f = self._vis(chunk)
            out.append(f[: len(f) - pad] if pad else f)
        self.stats["encode_s"] += time.perf_counter() - t0
        self.stats["windows"] += len(clips)
        return np.concatenate(out, 0)

    def video_features(self, path: str) -> np.ndarray:
        """[n_windows, D] features over the whole video."""
        return self.encode_windows(self.decode_windows(path))

    def text_features(self, queries) -> np.ndarray:
        t0 = time.perf_counter()
        out = self._text_features(list(queries))
        dt = time.perf_counter() - t0
        self.stats["text_s"] += dt
        self.stats["query_ms"].append(dt * 1e3)
        self.stats["queries"] += len(out)
        return out

    def _text_features(self, queries) -> np.ndarray:
        return self._txt(tokenize(queries))

    def extract_to_dir(self, samples, video_root: str, out_dir: str):
        """samples: iterable of dicts {video_uid, query, ...}; writes
        ``feat_<i>.npz`` (``video`` [W, D], ``text`` [D]) like the
        reference's per-sample ``feat_*.pt``, keeping one video's features
        cached."""
        os.makedirs(out_dir, exist_ok=True)
        vid_cache = {}
        for i, s in enumerate(samples):
            vid = s["video_uid"]
            if vid not in vid_cache:
                vid_cache = {vid: self.video_features(
                    osp.join(video_root, f"{vid}.mp4"))}
            np.savez(
                osp.join(out_dir, f"feat_{i}.npz"),
                video=vid_cache[vid],
                text=self.text_features([s["query"]])[0],
            )
