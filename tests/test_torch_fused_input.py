"""The port's device crop (``ops/fused_input``) against the JAX package's
on the same uint8 clips and crops: f32 within 1e-4 and bf16 within 1.6e-2
(one bf16 rounding step at |x| <= 2.7), with and without hflip; and the
train step's ``prep_video`` taking that path when the batch carries
crops."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avion_tpu.data.video_reader import CropSpec as JaxCropSpec
from avion_tpu.ops import fused_input as jfi
from avion_tpu_torch.data.video_reader import CropSpec
from avion_tpu_torch.ops import fused_input as pfi
from avion_tpu_torch.train.steps import prep_video

TOL = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(seed=0, b=5, t=2, h=40, w=48):
    rs = np.random.RandomState(seed)
    video = rs.randint(0, 256, (b, t, h, w, 3)).astype(np.uint8)
    x, y = rs.uniform(0, 0.5, b), rs.uniform(0, 0.4, b)
    cw, ch = rs.uniform(0.3, 0.5, b), rs.uniform(0.4, 0.6, b)
    crops = np.stack([x, y, cw, ch], 1).astype(np.float32)
    crops[0] = (0, 0, 1, 1)  # the whole frame
    flips = rs.rand(b) < 0.5
    flips[:2] = (False, True)
    return video, crops, flips


@pytest.mark.parametrize("hflip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_crop_resize_flip_normalize_matches_jax(dtype, hflip):
    video, crops, flips = _inputs()
    out_size = (32, 24)
    ref = jfi.crop_resize_flip_normalize(
        jnp.asarray(video), jnp.asarray(crops),
        jnp.asarray(flips) if hflip else None, out_size=out_size,
        dtype=JAX_DTYPE[dtype])
    got = pfi.crop_resize_flip_normalize(
        torch.from_numpy(video), torch.from_numpy(crops),
        torch.from_numpy(flips) if hflip else None, out_size=out_size,
        dtype=dtype)
    assert got.dtype == dtype and got.shape == (5, 2, 24, 32, 3)
    ref = np.asarray(ref, np.float32)
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= TOL[dtype], err
    assert np.abs(ref).max() <= 2.7


def test_whole_frame_crop_is_the_normalized_input():
    video, _, _ = _inputs(b=2)
    crops = torch.tensor([[0, 0, 1, 1]] * 2, dtype=torch.float32)
    got = pfi.crop_resize_flip_normalize(torch.from_numpy(video), crops,
                                         out_size=(48, 40),
                                         dtype=torch.float32)
    mean = np.array(pfi.OPENAI_MEAN) * 255
    std = np.array(pfi.OPENAI_STD) * 255
    np.testing.assert_allclose(got.numpy(), (video - mean) / std, atol=1e-4)
    flipped = pfi.crop_resize_flip_normalize(
        torch.from_numpy(video), crops, torch.tensor([True, False]),
        out_size=(48, 40), dtype=torch.float32)
    np.testing.assert_array_equal(flipped[0].numpy(),
                                  got[0].flip(2).numpy())
    np.testing.assert_array_equal(flipped[1].numpy(), got[1].numpy())


def test_batch_crop_array_matches_jax():
    specs = [(0.1, 0.2, 0.5, 0.6, True), (0.0, 0.0, 1.0, 1.0, False)]
    crops, flips = pfi.batch_crop_array([CropSpec(*s) for s in specs])
    ref_crops, ref_flips = jfi.batch_crop_array([JaxCropSpec(*s)
                                                 for s in specs])
    assert crops.dtype == torch.float32 and flips.dtype == torch.bool
    np.testing.assert_array_equal(crops.numpy(), np.asarray(ref_crops))
    np.testing.assert_array_equal(flips.numpy(), np.asarray(ref_flips))


def test_prep_video_takes_the_crop_path():
    video, crops, flips = _inputs(b=3)
    batch = {"video": torch.from_numpy(video), "crop": torch.from_numpy(crops),
             "hflip": torch.from_numpy(flips)}
    got = prep_video(batch["video"], torch.float32, batch=batch, crop_size=24)
    want = pfi.crop_resize_flip_normalize(
        batch["video"], batch["crop"], batch["hflip"], out_size=(24, 24),
        dtype=torch.float32)
    assert torch.equal(got, want)
    # without crop_size the crops are ignored, as in the JAX step
    plain = prep_video(batch["video"], torch.float32, batch=batch)
    assert plain.shape == (3, 2, 40, 48, 3)
