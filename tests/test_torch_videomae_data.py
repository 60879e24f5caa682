"""The port's VideoMAE data on the CPU against the JAX package's: RandAugment
and cube random erasing bit for bit on the same ``RandomState``, and every
``KineticsDataset`` and ``VideoClassyDataset('kinetics')`` item (training
views with every item's draws from seed 0, and the multi-view test) on a
layout ``chip_smoke.write_k400_fixture`` writes, with every side a multiple
of 8 (the native decoder's heap fault, ROADMAP), through each decode backend
pinned on both sides."""

import os.path as osp
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from avion_tpu.data import datasets as jds
from avion_tpu.data import rand_augment as jra
from avion_tpu_torch.data import datasets as pds
from avion_tpu_torch.data import rand_augment as pra
from avion_tpu_torch.train.videomae_finetune import AugmentedK400
from torch_native_decode import backend, native_decode_lib  # noqa: F401

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

CROP = 32


@pytest.fixture(scope="module")
def k400(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("k400"))
    return root, chip_smoke.write_k400_fixture(root, videos=4, frames=24,
                                               w=64, h=48, fps=10)


@pytest.fixture
def seeded_items(monkeypatch):
    """Every training item draws from seed 0 (they seed from the OS
    otherwise)."""
    orig = np.random.RandomState
    monkeypatch.setattr(np.random, "RandomState",
                        lambda seed=None: orig(0 if seed is None else seed))


def _assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_rand_augment_and_erase_are_bit_equal():
    clip = np.random.RandomState(0).randint(0, 256, (4, 40, 48, 3), np.uint8)
    ops = set()
    for seed in range(40):
        a = pra.rand_augment_clip(clip, np.random.RandomState(seed))
        b = jra.rand_augment_clip(clip, np.random.RandomState(seed))
        np.testing.assert_array_equal(a, b)
        ops.add(np.random.RandomState(seed).randint(len(pra._OPS)))
        a = pra.random_erase_clip(clip, np.random.RandomState(seed), 0.5)
        b = jra.random_erase_clip(clip, np.random.RandomState(seed), 0.5)
        np.testing.assert_array_equal(a, b)
    assert len(ops) > 10  # most ops were drawn first at least once


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_kinetics_items_match_jax(k400, seeded_items, backend, training):
    root, meta = k400
    kw = dict(clip_length=4, clip_stride=2, crop_size=CROP, patch_size=16,
              tubelet_size=2, mask_ratio=0.75, is_training=training)
    aug = dict(crop_size=CROP, mode="msc", hflip_prob=0.5)
    p = pds.KineticsDataset(root, meta, augment=pds.AugmentSpec(**aug), **kw)
    j = jds.KineticsDataset(root, meta, augment=jds.AugmentSpec(**aug), **kw)
    assert len(p) == len(j) == 4
    for i in range(len(p)):
        item = p[i]
        assert item["video"].shape == (4, CROP, CROP, 3)
        assert item["mask"].shape == (8,) and item["mask"].sum() == 6
        _assert_items_equal(item, j[i])


def test_kinetics_classy_training_views_match_jax(k400, seeded_items,
                                                  backend):
    root, meta = k400
    kw = dict(is_training=True, clip_length=4, clip_stride=2, num_sample=2)
    aug = dict(crop_size=CROP, mode="rrc", hflip_prob=0.5)
    p = pds.VideoClassyDataset("kinetics", root, meta,
                               augment=pds.AugmentSpec(**aug), **kw)
    j = jds.VideoClassyDataset("k400", root, meta,
                               augment=jds.AugmentSpec(**aug), **kw)
    for i in range(len(p)):
        got, want = p[i], j[i]
        assert len(got) == 2 and got[0]["label"] == i % 8
        for a, b in zip(got, want):
            _assert_items_equal(a, b)
    batch = pds.collate([p[0], p[1]])
    assert batch["video"].shape == (4, 4, CROP, CROP, 3)


@pytest.mark.parametrize("views", [(1, 1), (5, 3)], ids=["1x1", "5x3"])
def test_kinetics_test_views_match_jax(k400, backend, views):
    root, meta = k400
    kw = dict(is_training=False, clip_length=4, clip_stride=2,
              num_clips=views[0], num_crops=views[1])
    aug = dict(crop_size=CROP, mode="center")
    p = pds.VideoClassyDataset("kinetics", root, meta,
                               augment=pds.AugmentSpec(**aug), **kw)
    j = jds.VideoClassyDataset("kinetics", root, meta,
                               augment=jds.AugmentSpec(**aug), **kw)
    for i in range(len(p)):
        item = p[i]
        n = views[0] * views[1]
        assert item["video"].shape == ((n,) if n > 1 else ()) + \
            (4, CROP, CROP, 3)
        _assert_items_equal(item, j[i])


def test_augmented_k400_matches_jax(k400, seeded_items, backend):
    from avion_tpu.train.videomae_finetune import AugmentedK400 as JaxAug

    root, meta = k400
    kw = dict(is_training=True, clip_length=4, clip_stride=2, num_sample=2,
              use_randaug=True, erase_prob=0.9)
    aug = dict(crop_size=CROP, mode="rrc", hflip_prob=0.5)
    p = AugmentedK400("kinetics", root, meta,
                      augment=pds.AugmentSpec(**aug), **kw)
    j = JaxAug("kinetics", root, meta, augment=jds.AugmentSpec(**aug), **kw)
    for i in range(len(p)):
        for a, b in zip(p[i], j[i]):
            _assert_items_equal(a, b)
