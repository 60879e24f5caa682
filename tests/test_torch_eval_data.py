"""The port's eval datasets against the JAX package's on the layouts that
``chip_smoke.write_eval_fixtures`` writes (tiny: 64x48 at 10 fps): every
``VideoClassyDataset`` item (EK100-CLS, EGTEA, Charades-Ego; 1 or 2
temporal views, 1 or 3 crops) and every ``VideoCaptionMCQDataset`` item is
pixel-equal to JAX's, with the same decode backend on both sides."""

import os
import os.path as osp
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from avion_tpu.data import datasets as jds
from avion_tpu.data import video_reader as jvr
from avion_tpu.train.finetune_cls import load_actions as jax_load_actions
from avion_tpu_torch.data import datasets as pds
from avion_tpu_torch.data import video_reader as pvr
from avion_tpu_torch.train.finetune_cls import load_actions

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

# tiny layouts; every decoded side is a multiple of 8 (crop 24, the 3-crop
# decode 32 x 24): the native decoder corrupts its heap at some other sizes
TINY = dict(w=64, h=48, fps=10, chunk_s=2, clip_s=2, mir_clips=6,
            egtea_clips=4, charades_videos=4, charades_classes=5,
            mcq_items=4)
CROP = 24


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return chip_smoke.write_eval_fixtures(
        str(tmp_path_factory.mktemp("eval")), seed=0, **TINY)


@pytest.fixture(params=["native", "cv2"])
def backend(request, monkeypatch):
    """The same decode backend on both sides (``native`` only where the
    library is built and both packages load it)."""
    if request.param == "cv2":
        monkeypatch.setattr(jvr, "_lib", None)
        monkeypatch.setattr(jvr, "_lib_tried", True)
        monkeypatch.setattr(pvr, "_native_lib", lambda: None)
        return "cv2"
    monkeypatch.setattr(jvr, "_lib", jvr._lib)
    monkeypatch.setattr(jvr, "_lib_tried", jvr._lib_tried)
    pvr._native_lib.cache_clear()
    if not os.path.exists(pvr.LIB_PATH):
        pytest.skip("the native decode library is not built")
    try:
        both = jvr.native_available() and pvr.native_available()
    except OSError as e:  # half-written by a concurrent build
        pytest.skip(f"the native decode library did not load: {e}")
    if not both:
        pytest.skip("the native decode library is not available")
    return "native"


def _classy_args(layout, dataset):
    env = layout["env"]
    if dataset == "ek100_cls":
        _, _, mapping = load_actions(env["EK100_ACTIONS_CSV"])
        return (env["EK100_VIDEO_DIR"], env["EK100_VAL"],
                dict(chunk_len=layout["data"]["chunk_len"],
                     label_mapping=mapping))
    if dataset == "egtea":
        return (env["EGTEA_DATA_DIR"],
                osp.join(env["EGTEA_META_DIR"], "test_split1.txt"),
                dict(chunk_len=-1))
    return (env["CHARADES_DATA_DIR"],
            osp.join(env["CHARADES_META_DIR"],
                     "CharadesEgo_v1_test_only1st.csv"),
            dict(chunk_len=-1,
                 label_mapping={f"c{i:03d}": i
                                for i in range(TINY["charades_classes"])}))


def _assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("views", [(1, 1), (2, 1), (1, 3), (2, 3)],
                         ids=["1clip1crop", "2clips1crop", "1clip3crops",
                              "2clips3crops"])
@pytest.mark.parametrize("dataset", ["ek100_cls", "egtea", "charades_ego"])
def test_classy_items_match_jax(layout, backend, dataset, views):
    num_clips, num_crops = views
    root, meta, kw = _classy_args(layout, dataset)
    common = dict(is_training=False, clip_length=2, num_clips=num_clips,
                  num_crops=num_crops, **kw)
    j = jds.VideoClassyDataset(dataset, root, meta, **common,
                               augment=jds.AugmentSpec(crop_size=CROP,
                                                       mode="center"))
    p = pds.VideoClassyDataset(dataset, root, meta, **common,
                               augment=pds.AugmentSpec(crop_size=CROP,
                                                       mode="center"))
    assert len(p) == len(j) > 0
    n_views = num_clips * num_crops
    for i in range(len(p)):
        item = p[i]
        want = (n_views, 2, CROP, CROP, 3) if n_views > 1 \
            else (2, CROP, CROP, 3)
        assert item["video"].shape == want
        assert item["video"].reshape(n_views, -1).any(axis=1).all()
        _assert_items_equal(item, j[i])


def test_mcq_items_match_jax(layout, backend):
    env = layout["env"]
    meta = osp.join(env["EGO4D_MCQ_META_DIR"], "egomcq.json")
    kw = dict(clip_length=2, chunk_len=layout["data"]["chunk_len"], fps=10,
              crop_size=CROP)
    j = jds.VideoCaptionMCQDataset(env["EGO4D_MCQ_DATA_DIR"], meta, **kw)
    p = pds.VideoCaptionMCQDataset(env["EGO4D_MCQ_DATA_DIR"], meta, **kw)
    assert len(p) == len(j) == TINY["mcq_items"]
    for i in range(len(p)):
        item = p[i]
        assert item["videos"].shape == (5, 2, CROP, CROP, 3)
        assert item["options"].shape == (5, 77)
        assert item["videos"].reshape(5, -1).any(axis=1).all()
        _assert_items_equal(item, j[i])


def test_load_actions_matches_jax(layout):
    path = layout["env"]["EK100_ACTIONS_CSV"]
    assert load_actions(path) == jax_load_actions(path)


def test_classy_training_path_is_a_later_slice(layout):
    root, meta, kw = _classy_args(layout, "egtea")
    with pytest.raises(NotImplementedError, match="finetune slice"):
        pds.VideoClassyDataset("egtea", root, meta, is_training=True, **kw)
