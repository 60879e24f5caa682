"""RandAugment for video clips (host-side, numpy/cv2) + cube RandomErasing
(``avion_tpu.data.rand_augment``; given the same ``RandomState`` the same
clips, bit for bit).

Counterpart of the reference's CPU augmentation path for VideoMAE
finetuning (``classification_dataset.py:72-90``: pytorchvideo
RandAugment + timm-derived RandomErasing, ``random_erasing.py``).
Operations follow the standard RandAugment set; each clip gets ONE
sampled (op, magnitude) pair applied consistently across frames, which
is the video-consistent policy the reference uses.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


# --- per-frame ops (uint8 HWC in, uint8 HWC out) ---------------------------


def _autocontrast(img, _):
    out = np.empty_like(img)
    for c in range(img.shape[-1]):
        ch = img[..., c]
        lo, hi = int(ch.min()), int(ch.max())
        if hi <= lo:
            out[..., c] = ch
        else:
            lut = np.clip((np.arange(256) - lo) * 255.0 / (hi - lo), 0, 255)
            out[..., c] = lut.astype(np.uint8)[ch]
    return out


def _equalize(img, _):
    out = np.empty_like(img)
    for c in range(img.shape[-1]):
        ch = img[..., c]
        hist = np.bincount(ch.ravel(), minlength=256)
        nonzero = hist[hist > 0]
        if len(nonzero) <= 1:
            out[..., c] = ch
            continue
        step = (hist.sum() - nonzero[-1]) // 255
        if step == 0:
            out[..., c] = ch
            continue
        lut = (np.cumsum(hist) - hist // 2) // step
        lut = np.clip(lut, 0, 255).astype(np.uint8)
        out[..., c] = lut[ch]
    return out


def _invert(img, _):
    return 255 - img


def _posterize(img, mag):
    bits = 8 - int(4 * mag)
    mask = ~np.uint8((1 << (8 - max(bits, 1))) - 1)
    return img & mask


def _solarize(img, mag):
    thresh = int(255 * (1 - mag))
    return np.where(img >= thresh, 255 - img, img).astype(np.uint8)


def _blend(a, b, factor):
    return np.clip(
        a.astype(np.float32) * factor + b.astype(np.float32) * (1 - factor),
        0, 255,
    ).astype(np.uint8)


def _color(img, mag, sign):
    gray = img.mean(axis=-1, keepdims=True).astype(np.uint8)
    gray = np.repeat(gray, 3, axis=-1)
    return _blend(img, gray, 1.0 + sign * 0.9 * mag)


def _contrast(img, mag, sign):
    mean = np.full_like(img, int(img.mean()))
    return _blend(img, mean, 1.0 + sign * 0.9 * mag)


def _brightness(img, mag, sign):
    return _blend(img, np.zeros_like(img), 1.0 + sign * 0.9 * mag)


def _sharpness(img, mag, sign):
    if cv2 is None:
        return img
    blurred = cv2.GaussianBlur(img, (3, 3), 0)
    return _blend(img, blurred, 1.0 + sign * 0.9 * mag)


def _affine(img, m):
    if cv2 is None:
        return img
    h, w = img.shape[:2]
    return cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_CONSTANT, borderValue=(128, 128, 128))


def _rotate(img, mag, sign):
    deg = sign * 30.0 * mag
    h, w = img.shape[:2]
    m = cv2.getRotationMatrix2D((w / 2, h / 2), deg, 1.0) if cv2 else None
    return _affine(img, m) if m is not None else img


def _shear_x(img, mag, sign):
    s = sign * 0.3 * mag
    return _affine(img, np.float32([[1, s, 0], [0, 1, 0]]))


def _shear_y(img, mag, sign):
    s = sign * 0.3 * mag
    return _affine(img, np.float32([[1, 0, 0], [s, 1, 0]]))


def _translate_x(img, mag, sign):
    t = sign * 0.45 * mag * img.shape[1]
    return _affine(img, np.float32([[1, 0, t], [0, 1, 0]]))


def _translate_y(img, mag, sign):
    t = sign * 0.45 * mag * img.shape[0]
    return _affine(img, np.float32([[1, 0, 0], [0, 1, t]]))


_OPS = [
    ("AutoContrast", lambda im, m, s: _autocontrast(im, m)),
    ("Equalize", lambda im, m, s: _equalize(im, m)),
    ("Invert", lambda im, m, s: _invert(im, m)),
    ("Posterize", lambda im, m, s: _posterize(im, m)),
    ("Solarize", lambda im, m, s: _solarize(im, m)),
    ("Color", _color),
    ("Contrast", _contrast),
    ("Brightness", _brightness),
    ("Sharpness", _sharpness),
    ("Rotate", _rotate),
    ("ShearX", _shear_x),
    ("ShearY", _shear_y),
    ("TranslateX", _translate_x),
    ("TranslateY", _translate_y),
]


def rand_augment_clip(
    clip: np.ndarray,
    rng: np.random.RandomState,
    num_layers: int = 2,
    magnitude: int = 9,
    magnitude_std: float = 0.5,
) -> np.ndarray:
    """Apply ``num_layers`` sampled ops to every frame of [T,H,W,3] u8,
    with the same op/magnitude across frames (video-consistent)."""
    out = clip
    for _ in range(num_layers):
        name, fn = _OPS[rng.randint(len(_OPS))]
        mag = magnitude + rng.randn() * magnitude_std
        mag = float(np.clip(mag, 0, 10)) / 10.0
        sign = 1.0 if rng.rand() < 0.5 else -1.0
        out = np.stack([fn(f, mag, sign) for f in out])
    return out


def random_erase_clip(
    clip: np.ndarray,
    rng: np.random.RandomState,
    probability: float = 0.25,
    area_range: Tuple[float, float] = (0.02, 1 / 3),
    aspect_range: Tuple[float, float] = (0.3, 10 / 3),
    mode: str = "cube",
) -> np.ndarray:
    """timm-style RandomErasing, cube mode: the same box erased (with
    gaussian noise) across all frames (``random_erasing.py``)."""
    if rng.rand() >= probability:
        return clip
    t, h, w, c = clip.shape
    area = h * w
    out = clip.copy()
    for _ in range(10):
        target = rng.uniform(*area_range) * area
        log_aspect = (math.log(aspect_range[0]), math.log(aspect_range[1]))
        aspect = math.exp(rng.uniform(*log_aspect))
        eh = int(round(math.sqrt(target * aspect)))
        ew = int(round(math.sqrt(target / aspect)))
        if eh < h and ew < w:
            y = rng.randint(0, h - eh)
            x = rng.randint(0, w - ew)
            if mode == "cube":
                noise = rng.normal(128, 50, (eh, ew, c))
                out[:, y : y + eh, x : x + ew] = np.clip(noise, 0, 255
                                                         ).astype(np.uint8)
            else:  # per-frame noise
                noise = rng.normal(128, 50, (t, eh, ew, c))
                out[:, y : y + eh, x : x + ew] = np.clip(noise, 0, 255
                                                         ).astype(np.uint8)
            return out
    return clip
