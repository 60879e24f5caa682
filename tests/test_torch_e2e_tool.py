"""The port's convergence drill (``avion_tpu_torch.tools.e2e_convergence``)
against the JAX tool: each family's metadata equal to the JAX maker's for
the same arguments (both video writers stubbed), the mp4v clips of two
classes visibly different, the helpers and the five reports' stats and
curve lines equal to JAX's, the stall kill, every child command under
``avion_tpu_torch.``, report paths outside the repository, and one whole
CPU drill of ``--family clip --model CLIP_TINY`` with a preemption and a
resume (the tool's own limits: 120 s)."""

import json
import os
import os.path as osp
import pickle
import subprocess

import numpy as np
import pytest

import avion_tpu.tools.e2e_convergence as jt
import avion_tpu_torch.tools.e2e_convergence as pt

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
FAMILIES = ("clip", "videomae", "cls", "mir", "nlq")


def _stub_writers(monkeypatch):
    """Both packages' video writers touch an empty file."""
    import avion_tpu.data.video_reader as jvr

    touch = lambda path, *a, **k: open(path, "wb").close()  # noqa: E731
    monkeypatch.setattr(jvr, "write_test_video", touch)
    monkeypatch.setattr(pt, "write_seeded_video", touch)


def _tree(root):
    """Every file under ``root`` but the videos: its parsed content."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = osp.join(d, name)
            key = osp.relpath(path, root)
            if name.lower().endswith(".mp4"):
                out[key] = os.path.getsize(path)
            elif name.endswith(".pkl"):
                with open(path, "rb") as f:
                    out[key] = pickle.load(f)
            elif name.endswith(".npz"):
                with np.load(path) as z:
                    out[key] = {k: z[k] for k in z.files}
            else:
                with open(path) as f:
                    out[key] = f.read()
    return out


def _equal(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


MAKERS = {
    "clip": ("make_class_dataset", (3, 5), dict(w=64, h=48)),
    "videomae": ("make_mae_dataset", (3, 2), dict(n_frames=30, w=64, h=48)),
    "cls": ("make_cls_dataset", (6, 3), dict(w=64, h=48)),
    "mir": ("make_mir_dataset", (5, 3), dict(w=64, h=48,
                                             heldout_per_class=2)),
    "nlq": ("make_nlq_dataset", (3, 4), dict(val_per_concept=2)),
}


@pytest.mark.parametrize("family", FAMILIES)
def test_metadata_equals_jax_maker(family, tmp_path, monkeypatch):
    _stub_writers(monkeypatch)
    name, args, kw = MAKERS[family]
    ours = getattr(pt, name)(str(tmp_path / "port"), *args, **kw)
    theirs = getattr(jt, name)(str(tmp_path / "jax"), *args, **kw)
    assert osp.relpath(ours, tmp_path / "port") == osp.relpath(
        theirs, tmp_path / "jax")
    a, b = _tree(str(tmp_path / "port")), _tree(str(tmp_path / "jax"))
    assert len(a) > 2
    _equal(a, b)


def test_class_clips_differ_visibly(tmp_path):
    """Two classes' mp4v clips, decoded by the port's reader: frame 10
    differs by a mean absolute value above 20 (the JAX test's bound)."""
    from avion_tpu_torch.data.video_reader import VideoReader

    meta = pt.make_class_dataset(str(tmp_path), 2, 4, w=128, h=96)
    with open(meta, "rb") as f:
        assert {s[0] for s in pickle.load(f)} == {"cls000", "cls001"}
    frames = []
    for c in range(2):
        vr = VideoReader(str(tmp_path / f"cls{c:03d}.mp4" / "0.mp4"))
        assert len(vr) == 15 * 30 and (vr.width, vr.height) == (128, 96)
        frames.append(vr.get_batch([10])[0].astype(np.int32))
        vr.close()
    assert np.abs(frames[0] - frames[1]).mean() > 20


def test_captions_and_timestamps_match_jax():
    assert [pt.caption_for(c) for c in range(300)] == [
        jt.caption_for(c) for c in range(300)]
    for s in (0.0, 0.2, 7.25, 59.99, 60.0, 61.5, 3599.5, 3661.25):
        assert pt._sec2ts(s) == jt._sec2ts(s)


def test_read_log_matches_jax(tmp_path):
    rows = [{"step": 1, "train/loss": 2.0, "train/clip_acc": 10.0,
             "perf/duty_cycle": 0.5},
            {"step": 2, "eval/x": 1.0},
            {"step": 3, "train/loss": 1.5, "train/acc1": 20.0}]
    with open(tmp_path / "log.jsonl", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
        f.write("not json\n")
    for key in ("train/clip_acc", "train/acc1"):
        ours, theirs = (m.read_log(str(tmp_path), acc_key=key)
                        for m in (pt, jt))
        assert json.dumps(ours) == json.dumps(theirs)
    assert pt._last_step(str(tmp_path / "log.jsonl")) == 3


ZS = {
    "clip": {"ckpt_step": 100, "heldout_clips": 16, "zeroshot_top1": 1.0,
             "zeroshot_top5": 1.0},
    "videomae": {"ckpt_step": 80, "heldout_clips": 8, "mse_init": 2.0,
                 "mse_final": 0.5, "mse_ratio": 0.25},
    "cls": {"ckpt_step": 60, "heldout_clips": 12, "top1": 0.9, "topk": 1.0,
            "topk_k": 5, "verb_top1": 0.95, "noun_top1": 0.9,
            "chance": 0.0625},
    "mir": {"ckpt_step": 144, "heldout_clips": 36,
            "init": {"avg_map": 0.31, "avg_ndcg": 0.42},
            "trained": {"avg_map": 0.88, "avg_ndcg": 0.91}},
    "nlq": {"ckpt_step": 240, "val_queries": 32,
            "init": {"Rank@1_mIoU@0.3": 8.0, "mIoU": 6.5},
            "trained": {"Rank@1_mIoU@0.3": 72.0, "mIoU": 55.1}},
}
WRITERS = {"clip": "write_report", "videomae": "write_report_mae",
           "cls": "write_report_cls", "mir": "write_report_mir",
           "nlq": "write_report_nlq"}


@pytest.mark.parametrize("family", FAMILIES)
def test_report_matches_jax(family, tmp_path):
    """Every line from the step count on (the stats, the held-out result,
    the init-vs-trained table, the sampled curve) equals the JAX report's;
    the title, introduction, config and wall-time lines name the port and
    its card."""
    rows = [{"step": i, "loss": 3.0 - i * 0.01, "clip_acc": 5.0 + i,
             "perf/duty_cycle_win": 0.5 + i / 1000} for i in range(60)]
    texts = {}
    for name, mod in (("port", pt), ("jax", jt)):
        path = str(tmp_path / f"{name}.md")
        getattr(mod, WRITERS[family])(
            path, cfg={"family": family, "card": "cpu"}, rows=rows,
            resume_step=30, zs=ZS[family], wall_s=60.0)
        with open(path) as f:
            lines = f.read().splitlines()
        start = next(i for i, s in enumerate(lines)
                     if s.startswith("- steps logged"))
        texts[name] = lines[start:]
    assert texts["port"] == texts["jax"]
    assert "resume at step 30" in texts["port"][0]


def test_launch_training_kills_stalled_child(tmp_path, monkeypatch):
    """A child that stops logging steps gets SIGTERM, then SIGKILL, and
    TrainingStalled is raised."""
    calls = []

    class FakeProc:
        returncode = None

        def poll(self):
            return None

        def terminate(self):
            calls.append("terminate")

        def kill(self):
            calls.append("kill")

        def wait(self, timeout=None):
            if "kill" not in calls:
                raise subprocess.TimeoutExpired("x", timeout)
            FakeProc.returncode = -9
            return -9

        def send_signal(self, sig):
            calls.append(("signal", sig))

    monkeypatch.setattr(pt.subprocess, "Popen", lambda *a, **k: FakeProc())
    monkeypatch.setattr(pt.time, "sleep", lambda s: None)
    with pytest.raises(pt.TrainingStalled):
        pt.launch_training(
            str(tmp_path), "meta.pkl", str(tmp_path), model="CLIP_TINY",
            batch=4, epochs=1, workers=1, lr=1e-4,
            log_path=str(tmp_path / "out.log"), stall_timeout_s=0.01,
            timeout_s=60)
    assert calls == ["terminate", "kill"]


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("family", FAMILIES)
def test_child_commands_name_port_entries(family, device, tmp_path):
    """Every family's command runs ``-m avion_tpu_torch.<entry>``, carries
    the JAX command's overrides, no token names the JAX package, and
    ``--device`` reaches the child unless it is CUDA."""
    kw = dict(model="CLIP_TINY", batch=4, epochs=1, workers=1, lr=1e-4,
              extra=("x.y=1",), family=family)
    cmd = pt.training_command(str(tmp_path), "meta", "out", device=device,
                              **kw)
    assert cmd[1:3] == ["-m", pt._FAMILY_ENTRY[family]]
    assert cmd[2].startswith("avion_tpu_torch.")
    assert not any(t.startswith("avion_tpu.") or "avion_tpu." in t
                   for t in cmd)
    assert (cmd[-2:] == ["--device", "cpu"]) == (device == "cpu")
    # the JAX tool's overrides, entry module aside
    seen = []

    class Stop(Exception):
        pass

    def popen(args, **k):
        seen.append(args)
        raise Stop

    mp = pytest.MonkeyPatch()
    mp.setattr(jt.subprocess, "Popen", popen)
    try:
        with pytest.raises(Stop):
            jt.launch_training(str(tmp_path), "meta", "out",
                               log_path=str(tmp_path / "log"), **kw)
    finally:
        mp.undo()
    (theirs,) = seen
    assert theirs[2] == jt._FAMILY_ENTRY[family]
    assert cmd[3:len(theirs)] == theirs[3:]
    for module in pt._FAMILY_ENTRY.values():
        assert osp.exists(osp.join(ROOT, *module.split(".")) + ".py")


@pytest.mark.parametrize("family", FAMILIES)
def test_default_report_outside_repository(family):
    """The default report is ``<out>/E2E_<family>.md`` under the temporary
    directory: never one of the JAX package's ``docs/E2E*.md``."""
    out = pt.default_out(family)
    path = pt.default_report(out, family)
    assert path == osp.join(out, f"E2E_{family}.md")
    assert not osp.abspath(path).startswith(ROOT + os.sep)
    tracked = subprocess.run(["git", "ls-files"], cwd=ROOT,
                             capture_output=True, text=True).stdout.split()
    assert osp.basename(path) not in {osp.basename(t) for t in tracked}


def test_tool_refuses_missing_cuda(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        pt.main(["--out", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_cpu_drill_preempts_resumes_and_scores(tmp_path, monkeypatch,
                                               capsys):
    """``--family clip --model CLIP_TINY --device cpu``: phase A is
    preempted, phase B resumes past step 0 and ends; the loss falls, the
    restored checkpoint scores on the held-out windows, the report is
    written and the summary is the last line."""
    import functools

    monkeypatch.setattr(pt, "make_class_dataset", functools.partial(
        pt.make_class_dataset, w=96, h=64))
    # the children inherit the environment: one thread each, as the
    # suite's other process groups run (tests/torch_dist.py)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = str(tmp_path / "e2e")
    summary = pt.main([
        "--family", "clip", "--model", "CLIP_TINY", "--device", "cpu",
        "--classes", "4", "--windows", "8", "--batch", "8", "--epochs",
        "6", "--preempt-step", "4", "--workers", "1", "--out", out,
        "--timeout", "120", "--stall-timeout", "120", "--extra",
        "data.crop_size=32", "data.decode_size=40"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == summary
    assert summary["metric"] == "e2e_convergence_clip"
    assert summary["card"] == "cpu"
    assert 0 < summary["resume_step"] < summary["ckpt_step"] == 24
    assert summary["final_loss"] < summary["first_loss"]
    assert summary["heldout_clips"] == 16
    for key in ("zeroshot_top1", "init_zeroshot_top1"):
        assert 0.0 <= summary[key] <= 1.0
    # one checkpoint per epoch after the resume; the report beside them
    assert osp.exists(osp.join(out, "E2E_clip.md"))
    with open(osp.join(out, "run", "config.json")) as f:
        assert json.load(f)["model"]["name"] == "CLIP_TINY"
    # the children ran the plain attention (CPU) and wrote their counts
    counts = pt.read_counts(osp.join(out, "kernel_counts"))
    assert counts["plain_calls"].get("flash_fwd_lse", 0) > 0
    assert counts["launches"] == {}
    assert summary["plain_calls"]["train"] == counts["plain_calls"]
    assert summary["plain_calls"]["eval"].get("flash_fwd", 0) > 0
