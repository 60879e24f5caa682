"""The port's data path against the JAX package's on the same files and
the same random draws: the video reader, the crop samplers and tube masks,
frame sampling and ``load_clip``, both caption datasets (per-file and
sharded, ego4d and ek100_mir), and the ``DataLoader`` with its
shared-memory transfer.  Decoded pixels must be equal exactly, with the
same backend on both sides."""

import csv
import os
import os.path as osp
import pickle

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from avion_tpu.data import datasets as jds
from avion_tpu.data import loader as jloader
from avion_tpu.data import metadata as jmd
from avion_tpu.data import sampling as jsampling
from avion_tpu.data import shards as jshards
from avion_tpu.data import transforms as jtf
from avion_tpu.data import video_reader as jvr
from avion_tpu_torch.data import datasets as pds
from avion_tpu_torch.data import loader as ploader
from avion_tpu_torch.data import metadata as pmd
from avion_tpu_torch.data import sampling as psampling
from avion_tpu_torch.data import shards as pshards
from avion_tpu_torch.data import transforms as ptf
from avion_tpu_torch.data import video_reader as pvr
from torch_native_decode import (backend, force_cv2,  # noqa: F401
                                 native_decode_lib)

FPS = 10
CHUNK = 2  # seconds per chunk file
W, H = 48, 40


def _write_video(path, n_frames, seed, w=W, h=H, fps=FPS):
    """Seeded noise frames, so that every crop and frame id shows."""
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    rs = np.random.RandomState(seed)
    for _ in range(n_frames):
        vw.write(rs.randint(0, 256, (h, w, 3), np.uint8))
    vw.release()


@pytest.fixture(scope="module")
def ego4d(tmp_path_factory):
    """Chunked layout root/<vid>.mp4/<chunk_start>.mp4 (3 chunks of 2 s
    at 10 fps) and an ego4d metadata pkl; one row names a missing video."""
    root = str(tmp_path_factory.mktemp("ego4d"))
    for v, vid in enumerate(("vid_a", "vid_b")):
        d = osp.join(root, f"{vid}.mp4")
        os.makedirs(d)
        for c, chunk in enumerate((0, 2, 4)):
            _write_video(osp.join(d, f"{chunk}.mp4"), CHUNK * FPS,
                         seed=10 * v + c)
    rows = [("vid_a", 0.5, 3.5, "opens the drawer"),
            ("vid_b", 1.0, 5.0, ["washes hands", "rinses hands"]),
            ("vid_a", 4.0, 40.0, "closes the door"),
            ("nope", 0.0, 2.0, "a video that is not there"),
            ("vid_b", 2.2, 3.1, "picks up a cup"),
            ("vid_a", 1.9, 4.4, "puts down the cup")]
    meta = osp.join(root, "meta.pkl")
    with open(meta, "wb") as f:
        pickle.dump(rows, f)
    return root, meta


# with out_size=None the output is the crop's own size.  The native
# decoder corrupts its heap at some output sizes (24 x 20 and 24 x 30 here:
# sws_scale writes past the packed output), so every size in these tests
# has sides that are multiples of 8: 48 x 40, 32 x 24, 32 x 32
CROPS = [None, (0.1, 0.2, 0.7, 0.6, True, False),
         (0.3, 0.0, 0.67, 0.8, False, True)]


@pytest.mark.parametrize("crop", CROPS)
def test_reader_get_batch_matches_jax(ego4d, backend, crop):
    root, _ = ego4d
    path = osp.join(root, "vid_b.mp4", "2.mp4")
    a = jvr.VideoReader(path, backend=backend)
    b = pvr.VideoReader(path, backend=backend)
    assert b.backend == backend
    assert (len(a), a.get_avg_fps(), a.width, a.height) == \
        (len(b), b.get_avg_fps(), b.width, b.height)
    ids = [7, 3, 3, 15, 0, 19]
    for out_size in (None, (32, 16)):
        got = b.get_batch(ids, pvr.CropSpec(*crop) if crop else None,
                          out_size)
        ref = a.get_batch(ids, jvr.CropSpec(*crop) if crop else None,
                          out_size)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)
    a.close()
    b.close()


def test_unloadable_library_means_cv2(tmp_path, monkeypatch):
    """A library that exists but cannot load (built against FFmpeg on
    another host) is no native backend: the reader takes cv2."""
    junk = tmp_path / "libavion_decode.so"
    junk.write_bytes(b"not a shared object")
    monkeypatch.setattr(pvr, "LIB_PATH", str(junk))
    pvr._native_lib.cache_clear()
    try:
        assert not pvr.native_available()
        assert pvr.default_backend() == "cv2"
        path = str(tmp_path / "v.mp4")
        _write_video(path, 5, seed=0)
        assert pvr.VideoReader(path).backend == "cv2"
        with pytest.raises(pvr.DecodeError):
            pvr.write_test_video(str(tmp_path / "w.mp4"), 4)
    finally:
        pvr._native_lib.cache_clear()


SAMPLERS = {
    "sample_rrc": lambda m, rs: m.sample_rrc(rs, (0.3, 1.0), hflip_prob=0.5,
                                             vflip_prob=0.5),
    "sample_rrc_fallback": lambda m, rs: m.sample_rrc(rs, (2.0, 3.0),
                                                      hflip_prob=0.5),
    "sample_msc": lambda m, rs: m.sample_msc(rs, 456, 256, 224,
                                             hflip_prob=0.5),
    "center_crop_spec": lambda m, rs: m.center_crop_spec(340, 256),
    "spatial_three_crops": lambda m, rs: (m.spatial_three_crops(456, 256)
                                          + m.spatial_three_crops(200, 300)),
    "temporal_clip_offsets": lambda m, rs: (m.temporal_clip_offsets(100, 32, 3)
                                            + m.temporal_clip_offsets(20, 32, 1)),
    "tube_mask": lambda m, rs: m.tube_mask(rs, 8, 14, 14, 0.9),
    "tube_mask_batch": lambda m, rs: m.tube_mask_batch(rs, 4, 8, 14, 14, 0.75),
}


def _fields(x):
    if isinstance(x, list):
        return [_fields(v) for v in x]
    if isinstance(x, (jvr.CropSpec, pvr.CropSpec)):
        return (x.x, x.y, x.w, x.h, x.hflip, x.vflip)
    return x


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_samplers_match_jax(name):
    fn = SAMPLERS[name]
    for seed in range(20):
        ref = fn(jtf, np.random.RandomState(seed))
        got = fn(ptf, np.random.RandomState(seed))
        if isinstance(ref, np.ndarray):
            np.testing.assert_array_equal(got, ref)
        else:
            assert _fields(got) == _fields(ref)
    assert ptf.OPENAI_MEAN == jtf.OPENAI_MEAN
    assert (ptf.IMAGENET_MEAN, ptf.IMAGENET_STD) == \
        (jtf.IMAGENET_MEAN, jtf.IMAGENET_STD)


def test_frame_ids_match_jax():
    for seed in range(10):
        for args in ((10, 50, 8), (0, 7, 4), (3, 121, 16)):
            for jitter in (False, True):
                assert psampling.get_frame_ids(
                    *args, jitter=jitter, rng=np.random.RandomState(seed)) == \
                    jsampling.get_frame_ids(
                        *args, jitter=jitter, rng=np.random.RandomState(seed))
        for total, shift in ((100, True), (100, False), (10, True)):
            assert psampling.strided_frame_ids(
                total, 16, 4, shift, np.random.RandomState(seed)) == \
                jsampling.strided_frame_ids(
                    total, 16, 4, shift, np.random.RandomState(seed))


# (vid, start, end, chunk_len, crop, jitter): spanning chunks, past the
# last chunk (walk-back), a missing video (placeholder), one file
LOAD_CASES = {
    "chunked": ("vid_a", 0.5, 3.5, CHUNK, (0.1, 0.2, 0.7, 0.6, True, False),
                True),
    "walk_back": ("vid_a", 4.0, 40.0, CHUNK, None, True),
    "missing": ("nope", 0.0, 2.0, CHUNK, None, False),
    "one_file": ("vid_b.mp4/0", 0.2, 1.8, -1, (0.0, 0.0, 0.5, 0.5, False,
                                                 False), True),
}


@pytest.mark.parametrize("case", sorted(LOAD_CASES))
def test_load_clip_matches_jax(ego4d, backend, case):
    root, _ = ego4d
    vid, start, end, chunk_len, crop, jitter = LOAD_CASES[case]
    out = []
    for mod, vr_mod in ((jsampling, jvr), (psampling, pvr)):
        out.append(mod.load_clip(
            root, vid, "mp4", start, end, chunk_len=chunk_len, fps=FPS,
            clip_length=6, crop=vr_mod.CropSpec(*crop) if crop else None,
            out_size=(32, 24), jitter=jitter, rng=np.random.RandomState(4),
            reader_cache={}))
    assert out[1].shape == (6, 24, 32, 3)
    np.testing.assert_array_equal(out[1], out[0])
    if case == "missing":
        assert not out[1].any()


def _caption_datasets(root, meta, augment, **kw):
    """The JAX package's and the port's ego4d dataset, built alike."""
    return tuple(mod.VideoCaptionDataset(
        "ego4d", root, meta, chunk_len=CHUNK, fps=FPS,
        augment=mod.AugmentSpec(**augment), **kw) for mod in (jds, pds))


def _assert_items_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]),
                                      err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, k


def test_caption_dataset_eval_items_match_jax(ego4d, backend):
    root, meta = ego4d
    aug = dict(crop_size=32, mode="center")
    ref_ds, got_ds = _caption_datasets(root, meta, is_training=False,
                                       clip_length=4, augment=aug,
                                       narration_selection="concat")
    assert len(got_ds) == len(ref_ds) == 6
    for i in range(len(ref_ds)):
        _assert_items_equal(got_ds[i], ref_ds[i])


@pytest.mark.parametrize("mode", ["rrc", "device_rrc"])
def test_caption_dataset_train_load_matches_jax(ego4d, backend, mode):
    root, meta = ego4d
    aug = dict(crop_size=32, mode=mode, decode_size=40, scale_min=0.3,
               hflip_prob=0.5)
    ref_ds, got_ds = _caption_datasets(root, meta, is_training=True,
                                       clip_length=4, augment=aug, subsample_stride=1)
    for i in range(len(ref_ds)):
        for seed in (i, 100 + i):
            ref = ref_ds._load(ref_ds.samples[i], np.random.RandomState(seed))
            got = got_ds._load(got_ds.samples[i], np.random.RandomState(seed))
            for r, g in zip(ref, got):
                if r is None:
                    assert g is None
                else:
                    np.testing.assert_array_equal(g, r)
                    assert np.asarray(g).dtype == np.asarray(r).dtype
    assert got_ds[0]["video"].shape == ((4, 40, 40, 3) if mode == "device_rrc"
                                        else (4, 32, 32, 3))


@pytest.fixture(scope="module")
def ek100(tmp_path_factory):
    """An EK100 MIR layout: chunked MP4 dirs, the retrieval csv, its
    sentence csv (a quoted narration with a comma, a blank line) and a
    relevancy pkl."""
    base = tmp_path_factory.mktemp("ek100")
    root = str(base / "videos")
    for k, vid in enumerate(("P01_01", "P01_02")):
        d = osp.join(root, "P01", f"{vid}.MP4")
        os.makedirs(d)
        _write_video(osp.join(d, "0.MP4"), 2 * CHUNK * FPS, seed=50 + k)

    def ts(sec):
        return f"00:00:{sec:05.2f}"

    meta_dir = str(base / "meta")
    os.makedirs(osp.join(meta_dir, "relevancy"))
    header = ["narration_id", "participant_id", "video_id",
              "narration_timestamp", "start_timestamp", "stop_timestamp",
              "start_frame", "stop_frame", "narration", "verb", "verb_class",
              "noun", "noun_class"]
    rows = [[str(i), "P01", "P01_01" if i % 2 == 0 else "P01_02", "x",
             ts(0.3 + 0.2 * i), ts(3.0), "9", "90", f"cut onion {i}", "v",
             str(i), "n", str(2 * i)] for i in range(5)]
    meta_csv = osp.join(meta_dir, "EPIC_100_retrieval_train.csv")
    with open(meta_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)
    with open(osp.join(meta_dir, "EPIC_100_retrieval_train_sentence.csv"),
              "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["narration_id", "narration"])
        for r in rows:
            w.writerow([r[0], f"{r[8]}, then stir" if r[0] == "3" else r[8]])
        f.write("\n")
    rel = np.zeros((5, 5), np.float32)
    rel[np.arange(5), (np.arange(5) + 1) % 5] = 0.9  # a sentence of another row
    with open(osp.join(meta_dir, "relevancy",
                       "caption_relevancy_EPIC_100_retrieval_train.pkl"),
              "wb") as f:
        pickle.dump(rel, f)
    return root, meta_csv


def test_ek100_mir_extras_without_pandas(ek100):
    _, meta_csv = ek100
    sentences, rel, thr = pmd.load_ek100_mir_extras(meta_csv)
    ref_sentences, ref_rel, ref_thr = jmd.load_ek100_mir_extras(meta_csv)
    assert len(sentences) == len(ref_sentences) == 5
    for j in range(len(ref_sentences)):
        assert sentences[j][1] == ref_sentences.iloc[j, 1]
    np.testing.assert_array_equal(rel, ref_rel)
    assert thr == ref_thr


def test_ek100_mir_dataset_matches_jax(ek100, backend):
    root, meta_csv = ek100
    kw = dict(is_training=True, clip_length=2, chunk_len=CHUNK)
    ref_ds = jds.VideoCaptionDataset("ek100_mir", root, meta_csv,
                                     augment=jds.AugmentSpec(crop_size=32),
                                     **kw)
    got_ds = pds.VideoCaptionDataset("ek100_mir", root, meta_csv,
                                     augment=pds.AugmentSpec(crop_size=32),
                                     **kw)
    assert [vars(s) for s in got_ds.samples] == \
        [vars(s) for s in ref_ds.samples]
    for i in range(len(ref_ds)):
        ref, got = ref_ds[i], got_ds[i]  # the swap is deterministic here
        np.testing.assert_array_equal(got["text"], ref["text"])
        assert got["relevancy"] == ref["relevancy"] == np.float32(0.9)
        ref = ref_ds._load(ref_ds.samples[i], np.random.RandomState(i))
        got = got_ds._load(got_ds.samples[i], np.random.RandomState(i))
        np.testing.assert_array_equal(got[0], ref[0])


@pytest.fixture(scope="module")
def packed(ego4d, tmp_path_factory):
    """The same metadata packed into shards by each package, both
    decoding with cv2."""
    root, meta = ego4d
    out = []
    with pytest.MonkeyPatch.context() as mp:
        force_cv2(mp, jvr, pvr)
        for mod in (jshards, pshards):
            out_dir = str(tmp_path_factory.mktemp(mod.__name__.split(".")[0]))
            index = mod.pack_shards("ego4d", root, meta, out_dir,
                                    samples_per_shard=4, chunk_len=CHUNK,
                                    fps=FPS, pack_fps=FPS, short_side=0)
            out.append((out_dir, index))
    return out


def test_pack_shards_matches_jax(packed):
    (_, ref), (out_dir, got) = packed
    assert got == ref
    assert sorted(os.listdir(out_dir)) == [
        "index.json", "shard-000000.tar", "shard-000001.tar"]


def test_sharded_dataset_eval_items_match_jax(packed, backend):
    (ref_dir, _), (got_dir, _) = packed
    aug = dict(crop_size=32, mode="center")
    ref_ds = jshards.ShardedVideoCaptionDataset(
        ref_dir, is_training=False, clip_length=4,
        augment=jds.AugmentSpec(**aug))
    got_ds = pshards.ShardedVideoCaptionDataset(
        got_dir, is_training=False, clip_length=4,
        augment=pds.AugmentSpec(**aug))
    for i in range(len(ref_ds)):
        _assert_items_equal(got_ds[i], ref_ds[i])


@pytest.mark.parametrize("mode", ["rrc", "device_rrc"])
def test_sharded_dataset_train_decode_matches_jax(packed, backend, mode):
    (ref_dir, _), _ = packed
    aug = dict(crop_size=32, mode=mode, decode_size=40, hflip_prob=0.5)
    ref_ds = jshards.ShardedVideoCaptionDataset(
        ref_dir, is_training=True, clip_length=4,
        augment=jds.AugmentSpec(**aug))
    got_ds = pshards.ShardedVideoCaptionDataset(
        ref_dir, is_training=True, clip_length=4,
        augment=pds.AugmentSpec(**aug))
    for i in range(len(ref_ds)):
        row = ref_ds.samples[i]
        payload = ref_ds._read_member(row)
        assert got_ds._read_member(row) == payload
        ref = ref_ds._decode(payload, row["key"], np.random.RandomState(i))
        got = got_ds._decode(payload, row["key"], np.random.RandomState(i))
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    # a corrupt member: the same placeholder
    ref = ref_ds._decode(b"not an mp4", "bad", np.random.RandomState(0))
    got = got_ds._decode(b"not an mp4", "bad", np.random.RandomState(0))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


def test_concat_and_collate_match_jax(ego4d, backend):
    root, meta = ego4d
    aug = dict(crop_size=16, mode="center")
    ref_ds, got_ds = _caption_datasets(root, meta, is_training=False,
                                       clip_length=2, augment=aug)
    ref = jds.ConcatDataset([ref_ds, ref_ds])
    got = pds.ConcatDataset([got_ds, got_ds])
    assert len(got) == len(ref) == 12
    for i in (0, 5, 6, 11, -1):
        _assert_items_equal(got[i], ref[i])
    items = [ref[i] for i in range(3)]
    _assert_items_equal(pds.collate(items), jds.collate(items))
    nested = [[ref[0], ref[1]], ref[2]]
    _assert_items_equal(pds.collate(nested), jds.collate(nested))
    with pytest.raises(ValueError):
        pds.ConcatDataset([])


def _loader_batches(mod, ds, batch=2, **kw):
    dl = mod.DataLoader(ds, batch, **kw)
    out = [{k: np.asarray(v).copy() for k, v in b.items()} for b in dl]
    dl.close()
    return out, dl


def _items(n, shape):
    """Items in the caption contract, a function of the index alone (no
    decode: the loader's order, batching and transfer are under test).  A
    plain list is a map-style dataset, and workers unpickle it without
    importing this module."""
    return [{"video": np.random.RandomState(i).randint(0, 256, shape,
                                                       np.uint8),
             "text": np.full((77,), i, np.int32),
             "relevancy": np.float32(i)} for i in range(n)]


LOADER_CASES = {
    "shuffle_skip": dict(shuffle=True, seed=3, drop_last=True, skip_batches=1),
    "epoch_skip": dict(shuffle=True, seed=3, drop_last=True, epoch=1,
                       skip_batches=1),
    "in_order_keep_last": dict(shuffle=False, drop_last=False, epoch=2),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_batches_match_jax(case):
    """The in-process loader against the JAX one; the worker pool's
    batches against the in-process ones are in the next test."""
    kw = LOADER_CASES[case]
    ds = _items(7, (2, 8, 8, 3))
    ref, _ = _loader_batches(jloader, ds, num_workers=0, **kw)
    got, dl = _loader_batches(ploader, ds, num_workers=0, **kw)
    assert len(got) == len(ref) == len(dl) - kw.get("skip_batches", 0)
    for g, r in zip(got, ref):
        _assert_items_equal(g, r)


def test_loader_set_epoch_and_infinite_match_jax():
    ds = _items(7, (2, 8, 8, 3))
    dl = ploader.DataLoader(ds, 4, num_workers=0, shuffle=True, seed=1,
                            infinite=True)
    dl.set_epoch(1)
    it = iter(dl)
    got = [next(it)["text"][:, 0] for _ in range(3)]  # epochs 1, 2, 3
    ref_it = iter(jloader.DataLoader(ds, 4, num_workers=0, shuffle=True,
                                     seed=1, epoch=1, infinite=True))
    for g in got:
        np.testing.assert_array_equal(g, next(ref_it)["text"][:, 0])


def test_loader_workers_match_in_process():
    """Two workers, batches through shared memory and through the pickle
    pipe, shuffled with a skipped batch: equal to the in-process batches,
    with each large field counted by the way it came; no timing
    involved."""
    ds = _items(12, (8, 128, 128, 3))
    assert ds[0]["video"].nbytes * 4 >= ploader._SHM_MIN_BYTES
    kw = dict(batch=4, shuffle=True, seed=5, skip_batches=1)
    sync, _ = _loader_batches(ploader, ds, num_workers=0, **kw)
    shm, shm_dl = _loader_batches(ploader, ds, num_workers=2, use_shm=True,
                                  **kw)
    pkl, pkl_dl = _loader_batches(ploader, ds, num_workers=2, use_shm=False,
                                  **kw)
    assert len(sync) == len(shm) == len(pkl) == 2
    for a, b, c in zip(sync, shm, pkl):
        _assert_items_equal(b, a)
        _assert_items_equal(c, a)
    if ploader.shm_free_bytes() >= 1 << 24:  # room for the batches
        assert shm_dl.transfers == {"shm": 2}
    assert pkl_dl.transfers == {"pickle": 2}


_PRELOAD_SCRIPT = """
import sys

import numpy as np

from avion_tpu_torch.data.loader import DataLoader


class Probe:
    def __len__(self):
        return 4

    def __getitem__(self, i):
        return {"seen": np.array("preload_main" in sys.modules)}


if __name__ == "__main__":
    dl = DataLoader(Probe(), 2, num_workers=2, shuffle=False)
    print(all(bool(b["seen"].all()) for b in dl))
    dl.close()
"""


def test_forkserver_imports_the_script_once(tmp_path):
    """A script's loader workers find the script already imported under its
    own name by the forkserver, so their run of it as ``__mp_main__``
    reuses its imports (CPython's own preload of ``__main__`` never
    happens)."""
    import subprocess
    import sys

    script = tmp_path / "preload_main.py"
    script.write_text(_PRELOAD_SCRIPT)
    root = osp.dirname(osp.dirname(osp.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split() == ["True"]


@pytest.mark.parametrize("main,want", [
    (dict(spec="avion_tpu_torch.train.pretrain_clip"),
     ["avion_tpu_torch.train.pretrain_clip"]),
    (dict(spec="pytest.__main__"), []),
    (dict(file="/some/dir/chip_smoke.py"), ["chip_smoke"]),
    ({}, []),
])
def test_forkserver_preload_names(monkeypatch, main, want):
    """The main module's importable name (none for a package's
    ``__main__``, which the workers do not run), then the dataset's
    module."""
    import sys
    import types

    mod = types.ModuleType("__main__")
    mod.__spec__ = (types.SimpleNamespace(name=main["spec"])
                    if "spec" in main else None)
    if "file" in main:
        mod.__file__ = main["file"]
    monkeypatch.setitem(sys.modules, "__main__", mod)
    assert ploader.forkserver_preload() == want
    ds = pds.VideoCaptionDataset.__new__(pds.VideoCaptionDataset)
    assert ploader.forkserver_preload(ds) == \
        want + ["avion_tpu_torch.data.datasets"]


def test_small_shm_takes_the_pickle_path(monkeypatch):
    """When ``/dev/shm`` reports less free space than a field needs, the
    worker hands the field back as a plain array instead of creating a
    segment it could not fill."""
    created = []
    from multiprocessing import shared_memory

    real = shared_memory.SharedMemory

    def spy(*args, **kwargs):
        created.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(shared_memory, "SharedMemory", spy)
    monkeypatch.setattr(ploader, "shm_free_bytes", lambda: 1 << 20)
    ds = _items(4, (8, 128, 128, 3))
    ploader._worker_init(ds)
    try:
        out = ploader._worker_fetch_shm([0, 1, 2, 3])
    finally:
        ploader._worker_init(None)
    assert created == []
    assert isinstance(out["video"], np.ndarray)
    np.testing.assert_array_equal(out["video"],
                                  np.stack([it["video"] for it in ds]))
    dl = ploader.DataLoader(ds, 4, num_workers=2)
    dl._receive(out)
    assert dl.transfers == {"pickle": 1}
