"""Caption datasets producing numpy items (``avion_tpu.data.datasets``).

Map-style datasets whose ``__getitem__`` decodes a clip (native fused
decode or OpenCV) with host-sampled crop parameters and returns plain
numpy: frames stay uint8 until they reach the device.  The item contract
and every random draw are the JAX package's.

The classification dataset's eval views and the EgoMCQ dataset serve the
zero-shot suites; the classification training path and the Kinetics
dataset come with the finetune and VideoMAE slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import numpy as np

from avion_tpu_torch.data import metadata as md
from avion_tpu_torch.data.sampling import load_clip
from avion_tpu_torch.data.tokenizer import tokenize
from avion_tpu_torch.data.transforms import (
    center_crop_spec,
    sample_msc,
    sample_rrc,
)
from avion_tpu_torch.data.video_reader import CropSpec


class _PicklableCache:
    """Drops unpicklable reader caches when crossing process boundaries
    (loader workers)."""

    def __getstate__(self):
        state = self.__dict__.copy()
        if "_cache" in state:
            state["_cache"] = {}
        return state


@dataclass
class AugmentSpec:
    """Per-dataset augmentation policy (the reference's fused_decode_crop
    flags)."""

    crop_size: int = 224
    mode: str = "rrc"  # rrc | msc | center | none | device_rrc
    decode_size: int = 256  # host decode size for the device_rrc path
    scale_min: float = 0.5
    scale_max: float = 1.0
    hflip_prob: float = 0.0
    vflip_prob: float = 0.0

    def sample(self, rng: np.random.RandomState, src_w: int = 0,
               src_h: int = 0) -> CropSpec:
        if self.mode == "rrc":
            return sample_rrc(rng, (self.scale_min, self.scale_max),
                              hflip_prob=self.hflip_prob,
                              vflip_prob=self.vflip_prob)
        if self.mode == "msc":
            return sample_msc(rng, src_w or 456, src_h or 256, self.crop_size,
                              hflip_prob=self.hflip_prob)
        if self.mode == "center":
            if src_w and src_h:
                return center_crop_spec(src_w, src_h)
            return CropSpec()
        return CropSpec()


def device_crop(augment: AugmentSpec, rng, is_training: bool):
    """The device_rrc item fields ``crop`` [4] f32 (x, y, w, h) and
    ``hflip``: an RRC draw in training, the whole frame in eval."""
    c = sample_rrc(rng, (augment.scale_min, augment.scale_max),
                   hflip_prob=augment.hflip_prob) \
        if is_training else CropSpec()
    return np.asarray([c.x, c.y, c.w, c.h], np.float32), np.bool_(c.hflip)


def caption_item(frames, caption, rng, context_length: int,
                 narration_selection: str, crop_arr=None, hflip=None,
                 relevancy: float = 1.0) -> Dict[str, np.ndarray]:
    """The caption datasets' item: a list caption picks one narration
    (``random``) or joins them (``concat``); ``crop``/``hflip`` ride along
    on the device_rrc path."""
    if isinstance(caption, list):
        if narration_selection == "random":
            caption = caption[rng.randint(len(caption))] if caption else ""
        elif narration_selection == "concat":
            caption = ". ".join(caption)
    item = {
        "video": frames,
        "text": tokenize(str(caption), context_length),
        "relevancy": np.float32(relevancy),
    }
    if crop_arr is not None:
        item["crop"] = crop_arr
        item["hflip"] = hflip
    return item


def mir_caption(sentences, relevancy_mat, threshold, i, rng, caption):
    """EK100 MIR training: swap in a sentence whose relevancy to sample
    ``i`` passes ``threshold``; returns (caption, relevancy)."""
    pos = np.where(relevancy_mat[i] > threshold)[0]
    if len(pos):
        j = int(rng.choice(pos))
        if j < len(sentences) and j < relevancy_mat.shape[1]:
            return sentences[j][1], float(relevancy_mat[i][j])
    return caption, 1.0


class VideoCaptionDataset(_PicklableCache):
    """CLIP contrastive dataset (ego4d / ek100_mir)
    (``VideoCaptionDatasetCLIP``)."""

    def __init__(
        self,
        dataset: str,
        root: str,
        metadata_path: str,
        *,
        is_training: bool = True,
        clip_length: int = 4,
        chunk_len: int = 15,
        fps: float = 30,
        threads: int = 1,
        augment: Optional[AugmentSpec] = None,
        context_length: int = 77,
        narration_selection: str = "random",
        subsample_stride: Optional[int] = None,
        decode_fast: Optional[bool] = None,
    ):
        self.dataset = dataset
        self.root = root
        self.is_training = is_training
        self.clip_length = clip_length
        self.chunk_len = chunk_len
        self.fps = fps
        self.threads = threads
        self.augment = augment or AugmentSpec(
            mode="rrc" if is_training else "center")
        self.context_length = context_length
        self.narration_selection = narration_selection
        # fast native decode profile for training; eval keeps exact decode
        self.decode_fast = is_training if decode_fast is None else decode_fast

        if dataset == "ego4d":
            self.samples = md.load_ego4d(metadata_path)
        elif dataset == "ek100_mir":
            self.samples = md.load_ek100(root, metadata_path)
            if is_training:
                (self.sentences, self.relevancy_mat,
                 self.relevancy) = md.load_ek100_mir_extras(metadata_path)
            else:
                self.sentences = self.relevancy_mat = None
        else:
            raise ValueError(dataset)
        if subsample_stride:
            self.samples = self.samples[::subsample_stride]
            # relevancy rows stay aligned with the subsampled samples
            if getattr(self, "relevancy_mat", None) is not None:
                self.relevancy_mat = self.relevancy_mat[::subsample_stride]
        self._cache: dict = {}

    def __len__(self):
        return len(self.samples)

    def _load(self, s: md.Sample, rng):
        ext = "MP4" if self.dataset.startswith("ek100") else "mp4"
        fps = s.fps if self.dataset.startswith("ek100") else self.fps
        if self.augment.mode == "device_rrc":
            # the host decodes whole frames at a fixed size; the crop
            # travels with the batch and the device does the pixel work
            # (ops/fused_input.crop_resize_flip_normalize)
            crop, size = CropSpec(), (self.augment.decode_size,
                                      self.augment.decode_size)
        else:
            crop = self.augment.sample(rng)
            size = (self.augment.crop_size, self.augment.crop_size)
        frames = load_clip(
            self.root, s.vid, ext, s.start, s.end,
            chunk_len=self.chunk_len, fps=fps,
            clip_length=self.clip_length, threads=self.threads, crop=crop,
            out_size=size, jitter=self.is_training, rng=rng,
            reader_cache=self._cache, fast=self.decode_fast,
        )
        if self.augment.mode == "device_rrc":
            return (frames, *device_crop(self.augment, rng, self.is_training))
        return frames, None, None

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState() if self.is_training else np.random.RandomState(i)
        s = self.samples[i]
        frames, crop_arr, hflip = self._load(s, rng)
        caption, relevancy = s.caption, 1.0
        if self.dataset == "ek100_mir" and self.is_training:
            caption, relevancy = mir_caption(
                self.sentences, self.relevancy_mat, self.relevancy, i, rng,
                caption)
        return caption_item(frames, caption, rng, self.context_length,
                            self.narration_selection, crop_arr, hflip,
                            relevancy)


class VideoClassyDataset(_PicklableCache):
    """Classification dataset over the caption datasets' video layouts
    (``VideoClassyDataset``), eval views only: ``num_clips`` temporal
    views, each a centre square (``num_crops=1``) or left / centre / right
    squares of a wider decode (``num_crops=3``).  The training path
    (repeated augmentation, ``num_sample``) comes with the finetune
    slice."""

    def __init__(
        self,
        dataset: str,
        root: str,
        metadata_path: str,
        *,
        is_training: bool = True,
        clip_length: int = 16,
        clip_stride: int = 2,
        chunk_len: int = -1,
        threads: int = 1,
        augment: Optional[AugmentSpec] = None,
        num_clips: int = 1,
        num_crops: int = 1,
        label_mapping: Optional[dict] = None,
    ):
        if is_training:
            raise NotImplementedError(
                "VideoClassyDataset(is_training=True) comes with the "
                "finetune slice")
        if num_crops not in (1, 3):
            raise ValueError(f"num_crops must be 1 or 3, got {num_crops}")
        self.dataset = dataset
        self.root = root
        self.clip_length = clip_length
        self.clip_stride = clip_stride
        self.chunk_len = chunk_len
        self.threads = threads
        self.augment = augment or AugmentSpec(mode="center")
        self.num_clips = num_clips
        self.num_crops = num_crops
        self.label_mapping = label_mapping

        if dataset == "ek100_cls":
            self.samples = md.load_ek100(root, metadata_path)
        elif dataset == "egtea":
            self.samples, _ = md.load_egtea(root, metadata_path)
        elif dataset == "charades_ego":
            self.samples = md.load_charades_ego(root, metadata_path,
                                                is_trimmed=False)
        else:
            raise ValueError(dataset)
        self._cache: dict = {}

    def __len__(self):
        return len(self.samples)

    def _label(self, s: md.Sample):
        if self.dataset == "ek100_cls":
            if self.label_mapping is not None:
                return self.label_mapping[f"{s.verb}:{s.noun}"]
            return (s.verb, s.noun)
        if self.label_mapping is not None \
                and not isinstance(s.label, (int, np.integer)):
            if isinstance(s.label, list):  # multi-label (charades_ego)
                out = np.zeros(len(self.label_mapping), np.float32)
                for a in s.label:
                    out[self.label_mapping[a]] = 1.0
                return out
            return self.label_mapping[s.label]
        return s.label

    def __getitem__(self, i: int):
        rng = np.random.RandomState(i)
        s = self.samples[i]
        ext = "MP4" if self.dataset == "ek100_cls" else "mp4"
        cs = self.augment.crop_size
        # views are sub-windows spread over the annotated span; each covers
        # span / num_clips when the span is long enough, else they overlap
        span = s.end - s.start
        view_len = span if self.num_clips == 1 else max(
            span / self.num_clips, min(span, self.clip_length
                                       * self.clip_stride / max(s.fps, 1)))
        # num_crops=3 decodes a frame 4/3 as wide (an even width) and cuts
        # left / centre / right squares from it
        size = (int(cs * 4 / 3) // 2 * 2, cs) if self.num_crops == 3 \
            else (cs, cs)
        views = []
        for k in range(self.num_clips):
            if self.num_clips == 1:
                vs, ve = s.start, s.end
            else:
                max_start = max(0.0, span - view_len)
                vs = s.start + k * max_start / max(1, self.num_clips - 1)
                ve = min(s.end, vs + view_len)
            frames = load_clip(
                self.root, s.vid, ext, vs, ve, chunk_len=self.chunk_len,
                fps=s.fps, clip_length=self.clip_length,
                threads=self.threads, crop=CropSpec(), out_size=size,
                jitter=False, rng=rng, reader_cache=self._cache,
            )
            if self.num_crops == 3:
                w = frames.shape[2]
                for x0 in (0, (w - cs) // 2, w - cs):
                    views.append(frames[:, :, x0 : x0 + cs])
            else:
                views.append(frames)
        video = np.stack(views) if len(views) > 1 else views[0]
        return {"video": video, "label": self._label(s)}


class VideoCaptionMCQDataset(_PicklableCache):
    """EgoMCQ 5-way multiple choice (``VideoCaptionDatasetMCQ``): a text
    query and the clips of its candidates."""

    def __init__(self, root: str, metadata_path: str, *, clip_length: int = 4,
                 chunk_len: int = 15, fps: float = 30, threads: int = 1,
                 crop_size: int = 224, context_length: int = 77):
        self.root = root
        self.samples = md.load_ego4d_mcq(metadata_path)
        self.clip_length = clip_length
        self.chunk_len = chunk_len
        self.fps = fps
        self.threads = threads
        self.crop_size = crop_size
        self.context_length = context_length
        self._cache: dict = {}

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int):
        item = self.samples[str(i)]
        options = item["choices"]
        frames_options, narration_options = [], []
        for k in range(len(options)):
            opt = options[str(k)]
            frames_options.append(load_clip(
                self.root, opt["video_uid"], "mp4",
                float(opt["clip_start"]), float(opt["clip_end"]),
                chunk_len=self.chunk_len, fps=self.fps,
                clip_length=self.clip_length, threads=self.threads,
                crop=CropSpec(), out_size=(self.crop_size, self.crop_size),
                jitter=False, reader_cache=self._cache,
            ))
            narration_options.append(opt["clip_text"])
        return {
            "query": tokenize(item["query"]["clip_text"], self.context_length),
            "videos": np.stack(frames_options),
            "options": tokenize(narration_options, self.context_length),
            "answer": np.int32(item["answer"]),
            "type": np.int32(item["types"]),
        }


def collate(items: Sequence[Any]) -> Dict[str, np.ndarray]:
    """Stack a list of item dicts into batch arrays.  Items that are
    themselves lists (repeated augmentation) are flattened first, so the
    batch grows to len(items) * num_sample rows."""
    if any(isinstance(it, list) for it in items):
        items = [x for it in items
                 for x in (it if isinstance(it, list) else [it])]
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        out[key] = np.stack(vals) if isinstance(vals[0], np.ndarray) else np.asarray(vals)
    return out


class ConcatDataset:
    """Concatenation of map-style datasets (``torch.utils.data.
    ConcatDataset`` semantics; the reference mixes the ground-truth train
    pkl with auxiliary pseudo-narration pkls this way).  Picklable as long
    as the member datasets are."""

    def __init__(self, datasets: Sequence[Any]):
        if not datasets:
            raise ValueError("ConcatDataset needs at least one dataset")
        self.datasets = list(datasets)
        self.offsets = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, i: int):
        if i < 0:
            i += len(self)
        k = int(np.searchsorted(self.offsets, i, side="right"))
        lo = 0 if k == 0 else int(self.offsets[k - 1])
        return self.datasets[k][i - lo]
