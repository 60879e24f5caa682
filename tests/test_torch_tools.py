"""The port's host-only tools (``avion_tpu_torch.tools``: alignment
ablation, refinement eval, dataset tools, narration refinement, metrics
extractor, plots, chunk_videos, bench_decode) against the JAX package's on
the inputs of ``tests/test_tools.py``, ``tests/test_plots.py`` and
``tests/test_chunk_videos.py``: each scenario runs through both packages,
in directories of their own, and the outputs (return values, files,
printed lines) must be equal.  Video is decoded through cv2 on both
sides."""

import csv
import importlib
import json
import os
import os.path as osp
import pickle
import sys
import types

import numpy as np
import pytest

from avion_tpu.data import video_reader as jvr
from avion_tpu_torch.data import video_reader as pvr

cv2 = pytest.importorskip("cv2")


@pytest.fixture(autouse=True)
def cv2_both(monkeypatch):
    monkeypatch.setattr(jvr, "_lib", None)
    monkeypatch.setattr(jvr, "_lib_tried", True)
    monkeypatch.setattr(pvr, "_native_lib", lambda: None)


def _both(name):
    return (importlib.import_module(f"avion_tpu.tools.{name}"),
            importlib.import_module(f"avion_tpu_torch.tools.{name}"))


def _run(name, scenario, tmp_path, capsys=None):
    """(JAX's output, the port's) of ``scenario(module, dir)``."""
    outs = []
    for pkg, mod in zip(("jax", "port"), _both(name)):
        d = tmp_path / pkg
        d.mkdir()
        res = scenario(mod, d)
        if capsys is not None:
            res = (res, capsys.readouterr().out.replace(str(d), "<dir>"))
        outs.append(res)
    return outs


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b or (a != a and b != b)  # NaN equals NaN here


def _write_video(path, frames, fps=10, w=32, h=32, value=None):
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         (w, h))
    for i in range(frames):
        if value is None:
            frame = np.full((h, w, 3), 0, np.uint8)
            frame[:, :, 0] = min(2 * i, 255)
        else:
            frame = np.full((h, w, 3), value(i), np.uint8)
        vw.write(frame)
    vw.release()


def _read_rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_alignment_ablation_as_jax(tmp_path, capsys):
    def scenario(m, d):
        out = [m.perturb_window(10, 20, "add", 2),
               m.perturb_window(10, 20, "scale", 2.0),
               m.perturb_window(10, 20, "shift", 5),
               m.perturb_window(1, 3, "add", 5)]
        inp = str(d / "in.pkl")
        with open(inp, "wb") as f:
            pickle.dump([("vid1", 5.0, 8.0, "caption a"),
                         ("vid2", 0.5, 2.0, ["x", "y"])], f)
        out.append(m.augment_ego4d_pkl(inp, str(d / "out.pkl"), "add", 1.0))
        with open(d / "out.pkl", "rb") as f:
            out.append(pickle.load(f))
        csv_in = str(d / "in.csv")
        with open(csv_in, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["id", "pid", "vid", "ts", "start", "stop", "a", "b"])
            w.writerow(["0", "P01", "P01_01", "x", "00:00:10.00",
                        "00:00:20.00", "1", "2"])
        m.augment_ek100_csv(csv_in, str(d / "out.csv"), "scale", 1.5)
        out.append(_read_rows(d / "out.csv"))
        m.main(["--input", inp, "--output", str(d / "cli.pkl"), "--mode",
                "shift", "--amount", "0.5"])
        with open(d / "cli.pkl", "rb") as f:
            out.append(pickle.load(f))
        return out

    ref, got = _run("alignment_ablation", scenario, tmp_path, capsys)
    _same(got, ref)


def test_refinement_eval_as_jax(tmp_path):
    def scenario(m, d):
        refined = {"a": (0.0, 10.0), "b": (0.0, 10.0)}
        annotated = {"a": (0.0, 10.0), "b": (20.0, 30.0), "c": (0, 1)}
        out = [m.evaluate_refinement(refined, annotated),
               m.interval_iou((0, 4), (2, 6))]
        annotated = {k: (10.0, 20.0) for k in "abcd"}
        refined = {k: (12.5, 17.5) for k in "abcd"}
        sweep = m.scaling_analysis(refined, annotated, min_scale=0.5,
                                   max_scale=3.0, step=0.25)
        out += [sweep, m.peak_summary(sweep),
                m.scaling_analysis(refined, annotated, min_scale=3.0,
                                   max_scale=3.0, step=1.0,
                                   durations={k: 20.0 for k in "abcd"})]
        return out

    ref, got = _run("refinement_eval", scenario, tmp_path)
    _same(got, ref)


def test_dataset_tools_as_jax(tmp_path):
    def scenario(m, d):
        rows = [(f"v{i}", i, i + 2.0, f"cap {i}") for i in range(10)]
        inp = str(d / "m.pkl")
        with open(inp, "wb") as f:
            pickle.dump(rows, f)
        out = [m.subset_metadata(inp, str(d / "s.pkl"), stride=2),
               m.subset_metadata(inp, str(d / "s.pkl"), fraction=0.3),
               m.dataset_statistics(rows)]
        root = d / "vids"
        root.mkdir()
        _write_video(root / "flat.mp4", 40, value=lambda i: i % 255)
        (root / "vidA.mp4").mkdir()
        _write_video(root / "vidA.mp4" / "0.mp4", 20, value=lambda i: i)
        _write_video(root / "vidA.mp4" / "2.mp4", 10, value=lambda i: i)
        (root / "bad.mp4").write_bytes(b"junk")
        out.append(m.compute_video_lengths(str(root), str(d / "len.json")))
        with open(d / "len.json") as f:
            out.append(json.load(f))
        original = [("u0", "vidA", 1.0, 2.0, "cap a"),
                    ("u1", "vidB", 3.0, 4.0, "cap b")]
        stamped = m.attach_uuids(original, [("vidA", 1.0, 2.0, ["ra1", "ra2"]),
                                            ("vidB", 3.0, 4.0, ["rb1"])])
        merged = m.transplant_timestamps(
            [("u1", "vidB", 2.8, 4.4, "cap b"),
             ("u9", "vidZ", 0.0, 1.0, "zz")], stamped)
        out += [stamped, merged, m.strip_uuid(merged)]
        with pytest.raises(ValueError):
            m.attach_uuids(original, [("vidA", 9.0, 2.0, ["x"])])
        rows = [("v1", 0.0, 2.0, "opens the drawer"),
                ("v1", 2.5, 4.0, "opens the drawer"),
                ("v1", 10.0, 12.0, "washes hands")]
        out += [m.dedup_consecutive_captions(rows),
                m.hierarchical_merge(rows, lambda a, b: f"{a}; then {b}",
                                     max_gap=1.0)]
        samples = [("u1", "v1", 0.0, 2.0, "opens the drawer"),
                   ("u2", "v1", 1.5, 3.0, "opens drawer"),
                   ("u3", "v1", 5.0, 6.0, "cuts a tomato"),
                   ("u4", "v1", 5.8, 7.0, "washes the plate"),
                   ("u5", "v2", 0.0, 1.0, "pours water"),
                   ("u6", "v2", 0.5, 2.0, "pours water")]
        vocab = {"opens the drawer": [1, 0, 0],
                 "opens drawer": [0.99, 0.14, 0],
                 "cuts a tomato": [0, 1, 0], "washes the plate": [0, 0, 1],
                 "pours water": [0.5, 0.5, 0.5]}
        pairs = m.phase2_group_captions(
            samples, lambda t: np.asarray([vocab[x] for x in t], np.float32),
            similarity_threshold=0.9)
        out += [pairs, m.apply_merge_pairs(samples, pairs)]
        return out

    ref, got = _run("dataset_tools", scenario, tmp_path)
    _same(got, ref)
    assert ref[3]["bad.mp4"] == 0.0 and ref[-2] == [("u1", "u2")]


def _fake_transformers():
    class FakeTensor:
        shape = (1, 5)

        def to(self, device):
            return self

    class FakeProcessor:
        def apply_chat_template(self, messages, add_generation_prompt):
            return "TEMPLATED"

        def __call__(self, text, images, return_tensors):
            assert text == "TEMPLATED" and len(images) == 2
            return {"input_ids": FakeTensor()}

        def batch_decode(self, ids, skip_special_tokens):
            return ['{"start": 1.0, "end": 3.0, "caption": "c2"}']

    class FakeModel:
        def to(self, device):
            return self

        def eval(self):
            return self

        def generate(self, **kw):
            class Out:
                def __getitem__(self, idx):
                    return "SLICE"

            return Out()

    return types.SimpleNamespace(
        AutoProcessor=types.SimpleNamespace(
            from_pretrained=lambda p: FakeProcessor()),
        AutoModelForImageTextToText=types.SimpleNamespace(
            from_pretrained=lambda p: FakeModel()))


def test_narration_refinement_as_jax(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", _fake_transformers())
    for pkg in ("avion_tpu", "avion_tpu_torch"):
        monkeypatch.setattr(f"{pkg}.data.sampling.load_clip",
                            lambda *a, **k: np.zeros((2, 8, 8, 3), np.uint8))

    def scenario(m, d):
        items = m.build_refine_items(
            [("v1", 10.0, 14.0, "opens door"), ("v2", 5.0, 6.0, "closes")],
            window_pad=5.0)

        def fake_llm(item):
            if item.vid == "v1":
                return {"start": 11.0, "end": 13.0,
                        "caption": "opens the door"}
            return {"start": 99.0, "end": 98.0}

        results = m.refine_samples(items, fake_llm)
        out = [[vars(i) for i in items], results]
        path = str(d / "train.pkl")
        out.append(m.merge_to_train_pkl(results, path))
        with open(path, "rb") as f:
            out.append(pickle.load(f))
        m.merge_to_train_pkl(results, path, variant="scaled", scale=2.0)
        with open(path, "rb") as f:
            out.append(pickle.load(f))
        out += [m.temporal_iou((0, 2), (0, 2)), m.temporal_iou((0, 1), (2, 3)),
                m.cluster_spans([(10.0, 12.0), (10.05, 12.0), (10.0, 11.95),
                                 (30.0, 40.0)])]
        item = m.RefineItem(vid="v", start=9.0, end=13.0, caption="opens door",
                            window_start=0.0, window_end=60.0)
        cands = [{"start": 10.0, "end": 12.0}, {"start": 10.05, "end": 12.0},
                 {"start": 10.0, "end": 11.95}, {"start": 30.0, "end": 40.0},
                 {"start": 5.0, "end": 1.0}, None, {"bogus": 1}]
        out += [m.merge_multi_responses(item, cands),
                m.merge_multi_responses(item, [{"start": 10.0, "end": 12.0},
                                               None])]

        def infer_multi(it):
            if it.vid == "v":
                return cands
            raise RuntimeError("llm down")

        out.append(m.refine_samples_multi(
            [item, m.RefineItem(vid="w", start=1.0, end=2.0, caption="c2",
                                window_start=0.0, window_end=20.0)],
            infer_multi))
        item = m.RefineItem("v", 10.0, 12.0, "c", window_start=7.5,
                            window_end=22.5)
        out += [m.parse_vlm_reply('Sure! {"start": 2.0, "end": 4.5, '
                                  '"caption": "opens drawer"}', item),
                m.parse_vlm_reply("no json here", item),
                m.parse_vlm_reply('{"start": "x", "end": 1}', item)]
        infer = m.local_vlm_infer("/fake/path", video_root="/fake",
                                  clip_length=2, crop_size=8)
        out.append(infer(item))
        return out

    ref, got = _run("narration_refinement", scenario, tmp_path)
    _same(got, ref)
    assert ref[-1] == {"start": 8.5, "end": 10.5, "caption": "c2"}


def test_metrics_extractor_as_jax(tmp_path, capsys):
    def scenario(m, d):
        records = [{"step": 1, "m": 0.5}, {"step": 2, "m": 0.9},
                   {"step": 3, "m": 0.7}]
        out = [m.peak_metrics(records, ["m"], "max"),
               m.peak_metrics(records, ["m"], "final"),
               m.peak_metrics(records, ["m"], "min")]
        runs = []
        for i, scale in enumerate((1.0, 2.0)):
            run = d / f"run{i}"
            run.mkdir()
            with open(run / "log.jsonl", "w") as f:
                for r in records:
                    f.write(json.dumps({"step": r["step"],
                                        "m": r["m"] * scale}) + "\n")
                f.write("not json\n")
            runs.append(str(run))
        m.main(["--runs", *runs, "--metrics", "m", "--out",
                str(d / "peaks.csv")])
        rows = _read_rows(d / "peaks.csv")
        out.append([[c.replace(str(d), "<dir>") for c in r] for r in rows])
        return out

    ref, got = _run("metrics_extractor", scenario, tmp_path, capsys)
    _same(got, ref)


def test_plots_as_jax(tmp_path, capsys):
    def scenario(m, d):
        out = [m.segment_lengths_from_rows([("v", 1.0, 3.5, "c"),
                                            ("v", 0.0, 1.0, "c")]),
               m.segment_lengths_from_rows([("u", "v", 1.0, 3.5, "c")]),
               m.segment_lengths_from_rows([])]
        jp = str(d / "r.jsonl")
        with open(jp, "w") as f:
            f.write(json.dumps({"model_output": {"start": 1.0, "end": 4.0}})
                    + "\nnot json\n")
        cp = str(d / "m.csv")
        with open(cp, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["uuid", "video_id", "start_s",
                                              "end_s", "caption"])
            w.writeheader()
            w.writerow({"uuid": "u", "video_id": "v", "start_s": 1.5,
                        "end_s": 4.0, "caption": "c"})
        out += [m.load_segment_lengths(jp), m.load_segment_lengths(cp),
                m.relative_improvements(
                    [{"run_name": "base", "a": "10", "b": "20"},
                     {"run_name": "x", "a": "12", "b": "19"}], "base",
                    ["a", "b"])]
        r = np.random.RandomState(0)
        pkl_a, pkl_b = str(d / "a.pkl"), str(d / "b.pkl")
        with open(pkl_a, "wb") as f:
            pickle.dump([("v", 0.0, float(x), "c") for x in r.rand(50) * 10],
                        f)
        with open(pkl_b, "wb") as f:
            pickle.dump([("u", "v", 0.0, float(x), "c")
                         for x in r.rand(30) * 5], f)
        out.append(m.main(["segments", "--input", pkl_a, "--out",
                           str(d / "seg.png"), "--log-scale"]))
        out.append(m.main(["compare", "--input", pkl_a, "--input", pkl_b,
                           "--out", str(d / "cmp.png")]))
        peaks = str(d / "peaks.csv")
        with open(peaks, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["run_name", "m1", "m2"])
            w.writeheader()
            w.writerow({"run_name": "base", "m1": 1.0, "m2": 2.0})
            w.writerow({"run_name": "better", "m1": 2.0, "m2": 2.5})
        out.append(m.main(["improvement", "--input", peaks, "--baseline",
                           "base", "--out", str(d / "imp.png")]))
        out.append(sorted(p for p in os.listdir(d) if p.endswith(".png")))
        return out

    ref, got = _run("plots", scenario, tmp_path, capsys)
    _same(got, ref)
    assert ref[0][-1] == ["cmp.png", "imp.png", "seg.png"]


def _frames(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return np.stack(frames)


def test_chunk_videos_as_jax(tmp_path, capsys):
    def scenario(m, d):
        out = [m.scaled_size(640, 480, 288), m.scaled_size(480, 640, 288),
               m.scaled_size(200, 100, 288), m.scaled_size(640, 480, 0),
               m.scaled_size(501, 1000, 288)]
        src = str(d / "vid1.mp4")
        _write_video(src, 120, w=96, h=64)
        chunked = str(d / "chunked")
        outs = m.chunk_video(src, chunked, chunk_len=5, short_side=32,
                             backend="cv2")
        out.append(sorted(osp.relpath(p, d) for p in outs))
        out.append([_frames(p) for p in sorted(outs)])
        raw = d / "raw"
        raw.mkdir()
        _write_video(str(raw / "a.mp4"), 30, w=96, h=64)
        _write_video(str(raw / "b.mp4"), 30, w=96, h=64)
        (raw / "broken.mp4").write_bytes(b"not a video")
        res = m.chunk_dataset(str(raw), str(d / "out"), chunk_len=2,
                              short_side=0, workers=1, backend="cv2")
        out.append(sorted((osp.basename(v), n, err is None)
                          for v, n, err in res))
        out.append(m.main(["--input-dir", str(raw), "--output-dir",
                           str(d / "cli"), "--chunk-length", "2",
                           "--short-side", "0", "--workers", "1",
                           "--backend", "cv2"]))
        return out

    ref, got = _run("chunk_videos", scenario, tmp_path, capsys)
    _same(got, ref)
    assert ref[0][5] == ["chunked/vid1.mp4/0.mp4", "chunked/vid1.mp4/10.mp4",
                         "chunked/vid1.mp4/5.mp4"]


def test_bench_decode_as_jax(tmp_path, capsys):
    """Throughputs are timings, so the outputs compared are the clip they
    decode and the keys they report (cv2 only: no native library)."""
    def scenario(m, d):
        path = m.make_test_video(str(d / "v.mp4"), seconds=1, fps=10, w=96,
                                 h=64)
        fps = m.bench_reader(path, backend="cv2", clips=2, crop_size=32,
                             threads=1)
        assert fps > 0
        res = m.main(["--video", path, "--clips", "2", "--threads", "1"])
        return [_frames(path), sorted(res)]

    ref, got = _run("bench_decode", scenario, tmp_path)
    _same(got, ref)
    assert ref[1] == ["cv2_fps"]
