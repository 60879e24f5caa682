"""Caption datasets producing numpy items (``avion_tpu.data.datasets``).

Map-style datasets whose ``__getitem__`` decodes a clip (native fused
decode or OpenCV) with host-sampled crop parameters and returns plain
numpy: frames stay uint8 until they reach the device.  The item contract
and every random draw are the JAX package's.

The classification, EgoMCQ and Kinetics datasets come with the eval,
finetune and VideoMAE slices.
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
