"""One live end-to-end convergence drill on the card
(``avion_tpu.tools.e2e_convergence``).

Proof that the assembled port trains: it writes a learnable synthetic
dataset (seeded per-class video content, mp4v through cv2), runs the real
training entry in a child process (the real loader with its worker
processes), sends it SIGTERM mid-run (checkpoint and clean exit,
``parallel.launch``), relaunches the same command, which auto-resumes to
the end, then restores the final checkpoint and scores it on held-out data
against a fresh init.  The log (falling loss, resume step) is summarized
into a report.

Five families, each the port's entry in a child process:

- ``clip`` (default): ``train.pretrain_clip`` on chunked caption windows;
  held-out zero-shot retrieval over the class captions
  (:func:`zero_shot_sweep`).
- ``videomae``: ``train.videomae_pretrain`` on a Kinetics video list;
  held-out masked-reconstruction MSE (:func:`mae_eval`).
- ``cls``: ``train.finetune_cls`` on an EK100 layout (chunked videos and
  ``actions.csv``) with mixup / cutmix and label smoothing; held-out top-1
  and verb / noun marginalized top-1 (:func:`cls_eval`).
- ``mir``: ``train.finetune_mir`` on an EK100-MIR layout (sentence tables,
  graded relevancy pickles); held-out mAP / nDCG (:func:`mir_eval`).
- ``nlq``: ``egonlq.train_nlq`` (VSLNet) on learnable feature files;
  held-out R@k / IoU (:func:`nlq_eval`).

Each eval is a restore (the run's ``config.json`` and the newest
``<run>/ckpt/<step>/state.pt``) and a score function over a model and the
held-out set; the score runs the port's model on the tool's device (the
inference kernel for the towers on CUDA, VSLNet for NLQ).

The children run with ``AVION_KERNEL_COUNTS`` set, so each writes its
kernel launches at exit (``ops.flash_attention``); the summary sums them
(``launches["train"]``) beside the eval's own (``launches["eval"]``).

Usage::

    python -m avion_tpu_torch.tools.e2e_convergence \\
        [--family clip|videomae|cls|mir|nlq] [--classes 32] [--windows 64]
        [--batch 32] [--epochs 6] [--preempt-step 150] [--out DIR]
        [--report PATH] [--device cpu] [--timeout 3600]
        [--stall-timeout 900] [--extra section.key=value ...]

``--out`` defaults to ``<tmp>/avion_torch_e2e_<family>`` and the report to
``<out>/E2E_<family>.md``.  The last line of standard output is the JSON
summary (``"metric": "e2e_convergence_<family>"``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import os.path as osp
import pickle
import signal
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np

_NOUNS = [
    "knife", "drawer", "kettle", "sponge", "ladder", "wrench", "bottle",
    "carrot", "mirror", "pencil", "bucket", "window", "garlic", "hammer",
    "teapot", "folder", "sheets", "candle", "pillow", "shovel", "magnet",
    "basket", "helmet", "napkin", "button", "litter", "violin", "barrel",
    "gloves", "lentil", "switch", "strap",
]
_VERBS = ["picks up", "washes", "opens", "closes", "cuts", "stirs",
          "wipes", "folds"]

REPO_ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
COUNTS_ENV = "AVION_KERNEL_COUNTS"


def caption_for(cls: int) -> str:
    noun = _NOUNS[cls % len(_NOUNS)]
    verb = _VERBS[(cls // len(_NOUNS)) % len(_VERBS)]
    return f"#C C {verb} the {noun} number {cls}"


NOISE_FRAMES = 8  # the noise of frame i is draw i % NOISE_FRAMES


def write_seeded_video(path: str, n_frames: int, w: int, h: int, fps: int,
                       seed: int) -> None:
    """An mp4v clip (cv2) whose look is fixed by ``seed``: a base colour, a
    smooth texture and a bar, drifting a few pixels a frame, plus noise.
    Two seeds give clips whose frames differ by far more than the noise, so
    the classes of a drill stay learnable and distinct."""
    import cv2

    rs = np.random.RandomState(seed & 0x7FFFFFFF)
    base = rs.randint(30, 226, 3).astype(np.float32)
    coarse = rs.uniform(-80, 80, (max(2, h // 32), max(2, w // 32), 3))
    texture = cv2.resize(coarse.astype(np.float32), (2 * w, h),
                         interpolation=cv2.INTER_CUBIC)
    bar_w, speed = max(4, w // 12), 1 + int(rs.randint(0, 4))
    bar_phase = int(rs.randint(0, w))
    bar_colour = rs.randint(0, 256, 3).astype(np.float32)
    noise = rs.normal(0.0, 6.0, (NOISE_FRAMES, h, w, 3)).astype(np.float32)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), float(fps),
                         (w, h))
    if not vw.isOpened():
        raise RuntimeError(f"cv2.VideoWriter could not open {path}")
    try:
        for i in range(n_frames):
            shift = (i * speed) % w
            frame = base + texture[:, shift:shift + w]
            x0 = (bar_phase + 2 * i * speed) % w
            frame[:, x0:x0 + bar_w] = bar_colour
            frame += noise[i % NOISE_FRAMES]
            rgb = np.clip(frame, 0, 255).astype(np.uint8)
            vw.write(cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
    finally:
        vw.release()


def _write_all(jobs) -> None:
    """``write_seeded_video`` over ``(path, n_frames, w, h, fps, seed)``
    jobs in threads (cv2's encoder and numpy release the GIL), skipping a
    path that exists."""
    from concurrent.futures import ThreadPoolExecutor

    jobs = [j for j in jobs if not osp.exists(j[0])]
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(lambda job: write_seeded_video(*job), jobs))


def make_class_dataset(root: str, n_classes: int, windows_per_class: int,
                       chunk_len: int = 15, fps: int = 30,
                       w: int = 456, h: int = 256):
    """Seeded videos (one 15 s chunk per class, visually distinct), a
    train metadata pkl and the held-out window list."""
    os.makedirs(root, exist_ok=True)
    train, heldout, jobs = [], [], []
    rs = np.random.RandomState(0)
    for c in range(n_classes):
        vid = f"cls{c:03d}"
        d = osp.join(root, f"{vid}.mp4")
        os.makedirs(d, exist_ok=True)
        jobs.append((osp.join(d, "0.mp4"), chunk_len * fps, w, h, fps,
                     1000 + 7919 * c))
        cap = caption_for(c)
        for _ in range(windows_per_class):
            st = float(rs.uniform(0.2, chunk_len - 2.2))
            train.append((vid, st, st + 2.0, cap))
        for k in range(4):  # held-out eval windows (fixed offsets)
            st = 0.5 + k * 3.0
            heldout.append((vid, st, st + 2.0, c))
    _write_all(jobs)
    meta = osp.join(root, "train.pkl")
    with open(meta, "wb") as f:
        pickle.dump(train, f)
    with open(osp.join(root, "heldout.json"), "w") as f:
        json.dump(heldout, f)
    return meta


def make_mae_dataset(root: str, n_videos: int, repeats: int,
                     n_frames: int = 240, fps: int = 30,
                     w: int = 456, h: int = 256) -> str:
    """Seeded videos and a Kinetics-style 'path num_frames label' list
    (each video listed ``repeats`` times: the dataset samples a fresh
    strided window per row)."""
    os.makedirs(root, exist_ok=True)
    lines = []
    _write_all([(osp.join(root, f"mae{v:03d}.mp4"), n_frames, w, h, fps,
                 5000 + 7919 * v) for v in range(n_videos)])
    for v in range(n_videos):
        lines.extend([f"mae{v:03d}.mp4 {n_frames} {v}"] * repeats)
    meta = osp.join(root, "train.txt")
    with open(meta, "w") as f:
        f.write("\n".join(lines) + "\n")
    return meta


def _sec2ts(s: float) -> str:
    """seconds -> 'HH:MM:SS.xx' (inverse of metadata.datetime2sec)."""
    return f"{int(s) // 3600:02d}:{int(s) % 3600 // 60:02d}:{s % 60:05.2f}"


_EPIC_HEADER = ("uid,participant_id,video_id,narration_timestamp,"
                "start_timestamp,stop_timestamp,start_frame,stop_frame,"
                "narration,verb_id_raw,verb_class,noun_raw,noun_class")


def make_cls_dataset(root: str, n_classes: int, windows_per_class: int,
                     chunk_len: int = 15, fps: int = 30,
                     w: int = 456, h: int = 256) -> str:
    """EK100-layout classification set: chunked ``root/P00/P00_xxx.MP4/
    0.MP4`` seeded videos (one class each), ``actions.csv`` (verb / noun ->
    action id), a train csv in the EPIC column layout and fixed held-out
    windows."""
    os.makedirs(osp.join(root, "P00"), exist_ok=True)
    # distinct verb / noun pool sizes, so that both marginalized evals
    # aggregate several actions per class; (verb, noun) pairs stay unique
    # for n_classes <= lcm(8, 5) = 40
    n_verbs = max(1, min(8, n_classes))
    n_nouns = max(1, min(5, n_classes))
    if n_classes > 40:
        raise ValueError("verb / noun pair uniqueness needs n_classes <= 40")
    rows, heldout, actions = [], [], []
    rs = np.random.RandomState(0)
    dirs = [osp.join(root, "P00", f"P00_{c:03d}.MP4")
            for c in range(n_classes)]
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    _write_all([(osp.join(d, "0.MP4"), chunk_len * fps, w, h, fps,
                 2000 + 7919 * c) for c, d in enumerate(dirs)])
    for c in range(n_classes):
        vid = f"P00_{c:03d}"
        verb, noun = c % n_verbs, c % n_nouns
        actions.append((c, verb, noun, caption_for(c).replace(" ", "_")))
        for _ in range(windows_per_class):
            st = float(rs.uniform(0.2, chunk_len - 2.2))
            rows.append((vid, st, st + 2.0, verb, noun))
        for k in range(4):
            st = 0.5 + k * 3.0
            heldout.append((f"P00/{vid}", st, st + 2.0, c))
    with open(osp.join(root, "actions.csv"), "w") as f:
        f.write("id,verb,noun,action\n")
        for i, v, n, txt in actions:
            f.write(f"{i},{v},{n},{txt}\n")
    meta = osp.join(root, "train.csv")
    with open(meta, "w") as f:
        f.write(_EPIC_HEADER + "\n")
        for i, (vid, st, en, verb, noun) in enumerate(rows):
            f.write(f"{i},P00,{vid},{_sec2ts(st)},{_sec2ts(st)},"
                    f"{_sec2ts(en)},0,0,win {i},{verb},{verb},"
                    f"{noun},{noun}\n")
    with open(osp.join(root, "heldout.json"), "w") as f:
        json.dump(heldout, f)
    return meta


def make_mir_dataset(root: str, n_classes: int, windows_per_class: int,
                     chunk_len: int = 15, fps: int = 30,
                     w: int = 456, h: int = 256,
                     heldout_per_class: int = 3) -> str:
    """EK100-MIR layout: chunked seeded videos (one class each),
    ``train.csv`` / ``test.csv`` in the EPIC column layout, ``*_sentence.
    csv`` caption tables and graded relevancy pickles under
    ``relevancy/``.  Grades: 1.0 same class, 0.25 same verb."""
    import csv as _csv

    os.makedirs(osp.join(root, "P00"), exist_ok=True)
    os.makedirs(osp.join(root, "relevancy"), exist_ok=True)
    n_verbs = max(1, min(8, n_classes))
    captions = [caption_for(c) for c in range(n_classes)]
    rs = np.random.RandomState(0)
    dirs = [osp.join(root, "P00", f"P00_{c:03d}.MP4")
            for c in range(n_classes)]
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    _write_all([(osp.join(d, "0.MP4"), chunk_len * fps, w, h, fps,
                 3000 + 7919 * c) for c, d in enumerate(dirs)])
    header = _EPIC_HEADER.split(",")

    def write_split(name, per_class, fixed):
        rows = []
        for c in range(n_classes):
            for k in range(per_class):
                st = (0.5 + k * 3.0 if fixed
                      else float(rs.uniform(0.2, chunk_len - 2.2)))
                rows.append((c, f"P00_{c:03d}", st, st + 2.0))
        csv_path = osp.join(root, f"{name}.csv")
        with open(csv_path, "w", newline="") as f:
            wcsv = _csv.writer(f)
            wcsv.writerow(header)
            for i, (c, vid, st, en) in enumerate(rows):
                wcsv.writerow([i, "P00", vid, _sec2ts(st), _sec2ts(st),
                               _sec2ts(en), 0, 0, captions[c],
                               c % n_verbs, c % n_verbs, c, c])
        with open(osp.join(root, f"{name}_sentence.csv"), "w",
                  newline="") as f:
            wcsv = _csv.writer(f)
            wcsv.writerow(["id", "sentence"])
            for c, cap in enumerate(captions):
                wcsv.writerow([c, cap])
        rel = np.zeros((len(rows), n_classes), np.float32)
        for i, (c, *_rest) in enumerate(rows):
            rel[i, [j for j in range(n_classes)
                    if j % n_verbs == c % n_verbs]] = 0.25
            rel[i, c] = 1.0
        split = "train" if name == "train" else "test"
        with open(osp.join(root, "relevancy",
                           f"caption_relevancy_EPIC_100_retrieval_"
                           f"{split}.pkl"), "wb") as f:
            pickle.dump(rel, f)
        return csv_path

    write_split("test", heldout_per_class, fixed=True)
    return write_split("train", windows_per_class, fixed=False)


def make_nlq_dataset(root: str, n_concepts: int, samples_per_concept: int,
                     *, n_feat: int = 48, feat_hz: float = 8.0,
                     dv: int = 64, dq: int = 32,
                     val_per_concept: int = 4) -> str:
    """Learnable NLQ grounding set: per-sample feature files
    (``feat_<i>.npz``: video [n_feat, dv], pooled text [dq]) and
    official-layout annotation jsons.  Each query concept has a fixed
    video pattern added over the ground-truth span and a matching text
    embedding, so VSLNet can find the span from the query."""
    rs = np.random.RandomState(0)
    pv = rs.randn(n_concepts, dv).astype(np.float32)
    pv /= np.linalg.norm(pv, axis=1, keepdims=True)
    pq = rs.randn(n_concepts, dq).astype(np.float32)
    pq /= np.linalg.norm(pq, axis=1, keepdims=True)
    duration = n_feat / feat_hz

    def split(name, per_concept):
        feats = osp.join(root, "features" if name == "train"
                         else "features_val")
        os.makedirs(feats, exist_ok=True)
        videos = []
        idx = 0
        for k in range(n_concepts):
            for _ in range(per_concept):
                span = rs.randint(n_feat // 8, n_feat // 4 + 1)
                s = int(rs.randint(0, n_feat - span))
                e = s + span - 1
                video = rs.randn(n_feat, dv).astype(np.float32) * 0.5
                video[s: e + 1] += pv[k]
                text = pq[k] + rs.randn(dq).astype(np.float32) * 0.1
                np.savez(osp.join(feats, f"feat_{idx}.npz"),
                         video=video, text=text.astype(np.float32))
                videos.append({
                    "video_uid": f"v_{name}_{idx}",
                    "clips": [{
                        "clip_uid": f"c{idx}",
                        "video_start_sec": 0.0,
                        "video_end_sec": duration,
                        "annotations": [{"language_queries": [{
                            "query": f"where is concept {k}",
                            "clip_start_sec": s / feat_hz,
                            "clip_end_sec": (e + 1) / feat_hz,
                        }]}],
                    }],
                })
                idx += 1
        path = osp.join(root, f"nlq_{name}.json")
        with open(path, "w") as f:
            json.dump({"videos": videos}, f)
        return path

    split("val", val_per_concept)
    return split("train", samples_per_concept)


_FAMILY_ENTRY = {
    "clip": "avion_tpu_torch.train.pretrain_clip",
    "videomae": "avion_tpu_torch.train.videomae_pretrain",
    "cls": "avion_tpu_torch.train.finetune_cls",
    "mir": "avion_tpu_torch.train.finetune_mir",
    "nlq": "avion_tpu_torch.egonlq.train_nlq",
}

# VSLNet drill geometry (the training child and the restored eval share it)
_NLQ_DIMS = dict(dim=64, num_heads=4, max_pos_len=64,
                 video_feature_dim=64, query_feature_dim=32)


class TrainingStalled(RuntimeError):
    """The training child logged no new step for ``stall_timeout_s`` and
    was killed; auto-resume makes a relaunch safe."""


def training_command(root, meta, out_dir, *, model, batch, epochs, workers,
                     lr, extra=(), family="clip", clip_length=None,
                     device="cuda") -> list:
    """The child's command line: the family's entry with the drill's
    overrides, and ``--device`` when it is not CUDA."""
    if clip_length is None:
        clip_length = 4 if family == "clip" else 16
    if family == "clip":
        family_overrides = ("data.dataset=ego4d", "data.crop_size=224")
    elif family == "cls":
        # the finetune recipe: mixup / cutmix and smoothing, the label map
        # of the generated actions.csv, and the H128 head split (the
        # classifier reads the model.* widths, not the registry)
        family_overrides = (
            f"data.label_map={osp.join(root, 'actions.csv')}",
            "data.crop_size=224", "mixup=0.8", "cutmix=1.0",
            "model.vision_heads=6")
    elif family == "mir":
        family_overrides = ("data.crop_size=224",)
    else:
        family_overrides = ()
    if family == "nlq":
        cmd = [
            sys.executable, "-m", _FAMILY_ENTRY["nlq"],
            f"annotations={meta}",
            f"feature_dir={osp.join(root, 'features')}",
            f"val_annotations={osp.join(root, 'nlq_val.json')}",
            f"val_feature_dir={osp.join(root, 'features_val')}",
            f"output_dir={out_dir}", f"epochs={epochs}", f"lr={lr}",
            f"batch_size={batch}", "print_freq=5",
            *(f"{k}={v}" for k, v in _NLQ_DIMS.items()), *extra,
        ]
    else:
        cmd = [
            sys.executable, "-m", _FAMILY_ENTRY[family],
            f"model.name={model}", *family_overrides,
            f"data.root={root}", f"data.train_metadata={meta}",
            f"data.batch_size={batch}", f"data.num_workers={workers}",
            f"data.clip_length={clip_length}",
            f"optim.epochs={epochs}", f"optim.lr={lr}",
            "optim.warmup_epochs=0.5", "eval_freq=0", "save_freq=1",
            "print_freq=10", f"output_dir={out_dir}", *extra,
        ]
    if str(device) != "cuda":
        cmd += ["--device", str(device)]
    return cmd


def launch_training(root, meta, out_dir, *, model, batch, epochs, workers,
                    lr, log_path, preempt_after_steps=None,
                    timeout_s=3600, stall_timeout_s=900, extra=(),
                    family="clip", clip_length=None, device="cuda",
                    counts_dir=None):
    """Run the family's entry as a child process; with
    ``preempt_after_steps``, SIGTERM it once ``log.jsonl`` shows that step.

    A child that logs no new step for ``stall_timeout_s`` is killed and
    :class:`TrainingStalled` raised (the caller relaunches; auto-resume
    continues from the last checkpoint).  Past ``timeout_s`` the child is
    killed and RuntimeError raised.  Either kill is SIGTERM, then SIGKILL
    after 120 s.  ``counts_dir`` receives the child's kernel counts."""
    cmd = training_command(root, meta, out_dir, model=model, batch=batch,
                           epochs=epochs, workers=workers, lr=lr,
                           extra=extra, family=family,
                           clip_length=clip_length, device=device)
    env = dict(os.environ)
    if counts_dir is not None:
        env[COUNTS_ENV] = counts_dir
    logf = open(log_path, "ab")
    proc = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT,
                            cwd=REPO_ROOT, env=env)
    jsonl = osp.join(out_dir, "log.jsonl")
    t0 = time.monotonic()
    sent = False
    last_step = _last_step(jsonl)
    last_progress = time.monotonic()
    try:
        while proc.poll() is None:
            time.sleep(1)
            now = time.monotonic()

            def _kill(reason):
                # SIGTERM runs the entry's checkpoint-then-exit handler;
                # SIGKILL if it does not finish
                proc.terminate()
                try:
                    proc.wait(timeout=120)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                raise (TrainingStalled if reason == "stalled"
                       else RuntimeError)(f"training subprocess {reason}")

            if now - t0 > timeout_s:
                _kill("timed out")
            step = _last_step(jsonl)
            if step > last_step:
                last_step = step
                last_progress = now
            elif stall_timeout_s and now - last_progress > stall_timeout_s:
                print(f"[e2e] no step progress in {stall_timeout_s:.0f}s "
                      f"(last step {last_step}): killing the child",
                      file=sys.stderr)
                _kill("stalled")
            if preempt_after_steps and not sent:
                if step >= preempt_after_steps:
                    print(f"[e2e] sending SIGTERM at step {step} "
                          "(preemption drill)", file=sys.stderr)
                    proc.send_signal(signal.SIGTERM)
                    sent = True
    finally:
        logf.close()
    if preempt_after_steps and not sent:
        raise RuntimeError(
            "run finished before the preemption point: raise epochs "
            "or lower --preempt-step")
    return proc.returncode


def _last_step(jsonl):
    step = 0
    if osp.exists(jsonl):
        with open(jsonl) as f:
            for line in f:
                try:
                    row = json.loads(line)
                    step = max(step, int(row.get("step", 0)))
                except Exception:
                    pass
    return step


def read_log(out_dir, acc_key="train/clip_acc"):
    rows = []
    with open(osp.join(out_dir, "log.jsonl")) as f:
        for line in f:
            try:
                rows.append(json.loads(line))
            except Exception:
                pass
    out = []
    for r in rows:
        if "train/loss" not in r:
            continue
        out.append({"step": r.get("step"), "loss": r["train/loss"],
                    "clip_acc": r.get(acc_key, float("nan")),
                    **{k: v for k, v in r.items()
                       if k.startswith("perf/")}})
    return out


def read_counts(counts_dir) -> dict:
    """The kernel launches (``launches``) and plain calls (``plain_calls``)
    that the children wrote into ``counts_dir``, summed."""
    total = {"launches": Counter(), "plain_calls": Counter()}
    for path in sorted(glob.glob(osp.join(counts_dir, "*.json"))):
        with open(path) as f:
            got = json.load(f)
        for key in total:
            total[key].update(got.get(key, {}))
    return {k: dict(v) for k, v in total.items()}


def card_info(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (its
    name alone where ``nvidia-smi`` is missing), or ``cpu``."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        out = []
    index = device.index or 0
    return out[index] if index < len(out) else torch.cuda.get_device_name(
        device)


# ----------------------------------------------------------------- evals

def _run_config(out_dir):
    from avion_tpu_torch.core.config import TrainConfig

    with open(osp.join(out_dir, "config.json")) as f:
        return TrainConfig.from_dict(json.load(f))


def restore(model, out_dir):
    """Load the model part of the newest checkpoint under ``<out_dir>/
    ckpt`` into ``model`` (strict); returns its step."""
    from avion_tpu_torch.core.checkpoint import Checkpointer
    from avion_tpu_torch.train.common import latest_model_state

    ckpt = osp.join(out_dir, "ckpt")
    step = Checkpointer(ckpt).latest_step()
    if step is None:
        raise RuntimeError(f"no checkpoint under {ckpt}")
    model.load_state_dict(latest_model_state(ckpt), strict=True)
    return int(step)


def _init_and_restored(build, seed, out_dir, device):
    """(the run's fresh init, the restored model, its step), both on
    ``device``: ``build()`` (a meta-device model) drawn on the CPU from
    ``seed`` as the entries draw it, and a copy of it that takes the newest
    checkpoint."""
    import copy

    import torch

    model = build().to_empty(device="cpu")
    model.init_weights(torch.Generator().manual_seed(seed))
    restored = copy.deepcopy(model)
    step = restore(restored, out_dir)
    return model.to(device), restored.to(device), step


def _decode_windows(paths_windows, clip_length, crop_size):
    """uint8 [N, T, crop, crop, 3] center crops of the (path, start s,
    end s) windows, ``clip_length`` frames each (decoded in threads)."""
    from concurrent.futures import ThreadPoolExecutor

    from avion_tpu_torch.data.sampling import get_frame_ids
    from avion_tpu_torch.data.transforms import center_crop_spec
    from avion_tpu_torch.data.video_reader import VideoReader

    def decode(window):
        path, st, en = window
        vr = VideoReader(path)
        try:
            fps = vr.get_avg_fps() or 30.0
            ids = get_frame_ids(int(st * fps), min(int(en * fps), len(vr)),
                                num_segments=clip_length, jitter=False)
            crop = center_crop_spec(vr.width, vr.height)
            return vr.get_batch(ids, crop, (crop_size, crop_size))
        finally:
            vr.close()

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        return np.stack(list(pool.map(decode, paths_windows)))


def zero_shot_score(model, clips, labels, captions, batch) -> dict:
    """Top-1 / top-5 of each clip over the class captions, through the
    bf16 encoders (``eval.runners.CLIPEncoders``)."""
    from avion_tpu_torch.data.tokenizer import tokenize
    from avion_tpu_torch.eval.runners import CLIPEncoders

    toks = np.stack([tokenize(c) for c in captions]).astype(np.int32)
    enc = CLIPEncoders(model, batch=batch, weight_dtype="bf16")
    sims = enc.encode_images(clips) @ enc.encode_texts(toks).T
    order = np.argsort(-sims, axis=1)
    labels = np.asarray(labels)
    top1 = float((order[:, 0] == labels).mean())
    top5 = float((order[:, :5] == labels[:, None]).any(1).mean())
    return {"zeroshot_top1": round(top1, 4), "zeroshot_top5": round(top5, 4)}


def zero_shot_sweep(root, out_dir, *, batch, n_classes, device="cuda"):
    """Restore the final checkpoint and run held-out retrieval: 4 windows
    per class, classified over the class captions, by the restored model
    and by the run's fresh init (``init_*``)."""
    from avion_tpu_torch.train.pretrain_clip import build_model

    cfg = _run_config(out_dir)
    with open(osp.join(root, "heldout.json")) as f:
        heldout = json.load(f)
    clips = _decode_windows(
        [(osp.join(root, f"{vid}.mp4", "0.mp4"), st, en)
         for vid, st, en, _ in heldout],
        cfg.data.clip_length, cfg.data.crop_size)
    labels = [c for *_, c in heldout]
    captions = [caption_for(c) for c in range(n_classes)]
    init, model, step = _init_and_restored(lambda: build_model(cfg),
                                           cfg.seed, out_dir, device)
    zs = zero_shot_score(model, clips, labels, captions, batch)
    del model
    init = zero_shot_score(init, clips, labels, captions, batch)
    return {"ckpt_step": step, "heldout_clips": len(labels), **zs,
            **{f"init_{k}": v for k, v in init.items()}}


def mae_heldout(root, n_videos, clip_length, clip_stride, crop_size,
                patch_size, tubelet_size, mask_ratio, windows_per_video=2):
    """Fixed held-out windows and tube masks: (uint8 clips, bool masks)."""
    from avion_tpu_torch.data.sampling import strided_frame_ids
    from avion_tpu_torch.data.transforms import center_crop_spec, tube_mask
    from avion_tpu_torch.data.video_reader import VideoReader

    clips, masks = [], []
    g = crop_size // patch_size
    for v in range(n_videos):
        vr = VideoReader(osp.join(root, f"mae{v:03d}.mp4"))
        crop = center_crop_spec(vr.width, vr.height)
        for k in range(windows_per_video):
            rs = np.random.RandomState(31 * v + k)
            ids = strided_frame_ids(len(vr), clip_length, clip_stride,
                                    random_shift=True, rng=rs)
            clips.append(vr.get_batch(ids, crop, (crop_size, crop_size)))
            masks.append(tube_mask(rs, clip_length // tubelet_size, g, g,
                                   mask_ratio))
        vr.close()
    return np.stack(clips), np.stack(masks)


def mae_score(model, clips, masks, batch) -> float:
    """The mean masked-reconstruction MSE over the clips (normalized
    targets), each batch at its own size."""
    import torch

    from avion_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
    from avion_tpu_torch.losses.losses import videomae_loss
    from avion_tpu_torch.train.steps import prep_video

    device = next(model.parameters()).device
    model.eval()
    tot, cnt = 0.0, 0
    with torch.inference_mode():
        for i in range(0, len(clips), batch):
            cv = torch.from_numpy(clips[i: i + batch]).to(device)
            cm = torch.from_numpy(masks[i: i + batch]).to(device)
            v = prep_video(cv, model.dtype, mean=IMAGENET_MEAN,
                           std=IMAGENET_STD)
            pred, masked_idx = model(v, cm, deterministic=True)
            loss = videomae_loss(pred, v, masked_idx, model.patch_size,
                                 model.tubelet_size, True)["loss"]
            tot += float(loss) * len(cv)
            cnt += len(cv)
    return tot / cnt


def mae_eval(root, out_dir, *, batch, n_videos, windows_per_video=2,
             device="cuda"):
    """Restore the final VideoMAE checkpoint and measure held-out
    masked-reconstruction MSE against the same on the run's fresh init."""
    from avion_tpu_torch.train.videomae_pretrain import build_model

    cfg = _run_config(out_dir)
    d = cfg.data
    init, model, step = _init_and_restored(lambda: build_model(cfg),
                                           cfg.seed, out_dir, device)
    clips, masks = mae_heldout(root, n_videos, d.clip_length,
                               d.clip_stride, model.image_size,
                               model.patch_size, model.tubelet_size,
                               d.mask_ratio, windows_per_video)
    mse_final = mae_score(model, clips, masks, batch)
    del model
    mse_init = mae_score(init, clips, masks, batch)
    return {"ckpt_step": step, "heldout_clips": len(clips),
            "mse_init": round(mse_init, 4),
            "mse_final": round(mse_final, 4),
            "mse_ratio": round(mse_final / max(mse_init, 1e-9), 4)}


def cls_score(model, clips, ys, pairs, n_classes, batch) -> dict:
    """Top-1, top-k (k = min(5, classes)) and verb / noun marginalized
    top-1 of the classifier on uint8 clips."""
    import torch

    from avion_tpu_torch.data.transforms import normalize_video
    from avion_tpu_torch.eval.classification_metrics import (
        get_marginal_indexes, marginalize)

    device = next(model.parameters()).device
    model.eval()
    outs = []
    with torch.inference_mode():
        for i in range(0, len(clips), batch):
            v = normalize_video(torch.from_numpy(clips[i: i + batch]).to(
                device), dtype=torch.bfloat16)
            outs.append(model(v, deterministic=True).float().cpu().numpy())
    logits = np.concatenate(outs)
    ys = np.asarray(ys)
    order = np.argsort(-logits, axis=1)
    top1 = float((order[:, 0] == ys).mean())
    topk_k = min(5, n_classes)
    topk = float((order[:, :topk_k] == ys[:, None]).any(1).mean())
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    vprob = marginalize(probs, get_marginal_indexes(pairs, "verb"))
    nprob = marginalize(probs, get_marginal_indexes(pairs, "noun"))
    vy = np.asarray([pairs[c][0] for c in ys])
    ny = np.asarray([pairs[c][1] for c in ys])
    return {"top1": round(top1, 4), "topk": round(topk, 4),
            "topk_k": topk_k,
            "verb_top1": round(float((vprob.argmax(1) == vy).mean()), 4),
            "noun_top1": round(float((nprob.argmax(1) == ny).mean()), 4)}


def cls_eval(root, out_dir, *, batch, n_classes, device="cuda"):
    """Restore the final classifier and measure held-out top-1 / top-k and
    verb / noun marginalized top-1 on fixed center-crop windows."""
    from avion_tpu_torch.train.finetune_cls import (build_classifier,
                                                    load_actions)

    cfg = _run_config(out_dir)
    labels, pairs, _ = load_actions(osp.join(root, "actions.csv"))
    with open(osp.join(root, "heldout.json")) as f:
        heldout = json.load(f)
    clips = _decode_windows(
        [(osp.join(root, vid + ".MP4", "0.MP4"), st, en)
         for vid, st, en, _ in heldout],
        cfg.data.clip_length, cfg.model.image_size)
    _, model, step = _init_and_restored(
        lambda: build_classifier(cfg, len(labels)), cfg.seed, out_dir,
        device)
    got = cls_score(model, clips, [c for *_, c in heldout], pairs,
                    n_classes, batch)
    return {"ckpt_step": step, "heldout_clips": len(heldout), **got,
            "chance": round(1.0 / len(labels), 4)}


def mir_score(model, root, clip_length, crop_size, batch) -> dict:
    """mAP / nDCG of the held-out split (``test.csv``, its relevancy
    pickle), one caption per class in class order."""
    from avion_tpu_torch.data.datasets import AugmentSpec, VideoCaptionDataset
    from avion_tpu_torch.data.loader import DataLoader
    from avion_tpu_torch.eval.retrieval_metrics import get_map, get_ndcg
    from avion_tpu_torch.eval.runners import CLIPEncoders

    val_ds = VideoCaptionDataset(
        "ek100_mir", root, osp.join(root, "test.csv"), is_training=False,
        clip_length=clip_length, chunk_len=15,
        augment=AugmentSpec(crop_size=crop_size, mode="center"))
    with open(osp.join(root, "relevancy",
                       "caption_relevancy_EPIC_100_retrieval_test.pkl"),
              "rb") as f:
        rel = pickle.load(f)
    loader = DataLoader(val_ds, batch, shuffle=False, drop_last=False,
                        num_workers=0)
    res = CLIPEncoders(model, batch=batch).sweep_loader(loader)
    img, txt = res["image_embed"], res["text_embed"]
    # rows are grouped by class (test.csv's order), per class each
    n_videos = rel.shape[0]
    per = n_videos // rel.shape[1]
    tcls = txt[::per][: rel.shape[1]]
    sim = (img[:n_videos] @ tcls.T + 1) / 2
    vmap, tmap, amap = get_map(sim, rel)
    _, _, andcg = get_ndcg(sim, rel)
    return {"avg_map": round(float(amap), 4),
            "avg_ndcg": round(float(andcg), 4),
            "vis_map": round(float(vmap), 4),
            "txt_map": round(float(tmap), 4)}


def mir_eval(root, out_dir, *, batch, device="cuda"):
    """EK100-MIR retrieval metrics on the held-out split from the run's
    fresh init and from the restored checkpoint."""
    from avion_tpu_torch.train.finetune_mir import build_model

    cfg = _run_config(out_dir)
    d = cfg.data
    init, model, step = _init_and_restored(lambda: build_model(cfg),
                                           cfg.seed, out_dir, device)
    trained = mir_score(model, root, d.clip_length, d.crop_size, batch)
    del model
    init = mir_score(init, root, d.clip_length, d.crop_size, batch)
    with open(osp.join(root, "relevancy",
                       "caption_relevancy_EPIC_100_retrieval_test.pkl"),
              "rb") as f:
        n_rows = pickle.load(f).shape[0]
    return {"ckpt_step": step, "heldout_clips": int(n_rows),
            "init": init, "trained": trained}


def nlq_eval(root, out_dir, *, batch, device="cuda"):
    """R@k / IoU on the held-out NLQ split from the run's fresh init and
    from the restored checkpoint."""
    import torch

    from avion_tpu_torch.egonlq.nlq_dataset import (NLQFeatureDataset,
                                                    parse_nlq_annotations)
    from avion_tpu_torch.egonlq.train_nlq import (NLQConfig, _collate,
                                                  build_model, evaluate)

    cfg = NLQConfig(
        annotations=osp.join(root, "nlq_train.json"),
        val_annotations=osp.join(root, "nlq_val.json"),
        feature_dir=osp.join(root, "features"),
        val_feature_dir=osp.join(root, "features_val"),
        output_dir=out_dir, batch_size=batch, **_NLQ_DIMS)
    val = NLQFeatureDataset(parse_nlq_annotations(cfg.val_annotations),
                            cfg.val_feature_dir, cfg.max_pos_len)
    b0 = _collate([val[0]])
    device = torch.device(device)
    model = build_model(cfg, b0["video"].shape[-1],
                        b0["query"].shape[-1]).to(device)
    model.init_weights(torch.Generator(device).manual_seed(cfg.seed))
    init = evaluate(cfg, model)
    step = restore(model, out_dir)
    trained = evaluate(cfg, model)
    return {"ckpt_step": step, "val_queries": len(val),
            "init": {k: round(v, 2) for k, v in init.items()},
            "trained": {k: round(v, 2) for k, v in trained.items()}}


# --------------------------------------------------------------- reports

def _init_vs_trained_lines(zs):
    lines = ["", "## held-out eval: fresh init vs restored checkpoint",
             "", "| metric | init | trained |", "|---|---|---|"]
    for k in zs["trained"]:
        lines.append(f"| {k} | {zs['init'][k]} | {zs['trained'][k]} |")
    return lines


def _report_stats(cfg, rows, resume_step, wall_s, *, loss_label,
                  acc_line=None):
    """The stats block every family report shares: config, card, wall
    time, step count, first / last 10% loss means, an optional accuracy
    line and the duty-window summary."""
    first = rows[: max(1, len(rows) // 10)]
    last = rows[-max(1, len(rows) // 10):]
    mean = lambda rs, k: float(np.mean([r[k] for r in rs if k in r]))  # noqa
    duty = [r.get("perf/duty_cycle_win", r.get("perf/duty_cycle"))
            for r in rows
            if "perf/duty_cycle_win" in r or "perf/duty_cycle" in r]
    lines = [
        f"- config: `{json.dumps(cfg)}`",
        f"- total wall time: {wall_s:.0f}s on {cfg.get('card', 'n/a')}",
        f"- steps logged: {len(rows)} (resume at step {resume_step})",
        f"- {loss_label}: first-10% mean {mean(first, 'loss'):.4f} -> "
        f"last-10% mean {mean(last, 'loss'):.4f}",
    ]
    if acc_line is not None:
        label, key = acc_line
        lines.append(f"- {label}: {mean(first, key):.2f} -> "
                     f"{mean(last, key):.2f}")
    lines.append(
        f"- measured duty cycle (window median {np.median(duty):.3f}, "
        f"min {min(duty):.3f}, max {max(duty):.3f} over {len(duty)} "
        f"print windows)" if duty else "- duty cycle: n/a")
    return lines


def _report_curve(rows, *, loss_col="loss", acc_col=None):
    """The sampled loss-curve table every family report ends with."""
    curve = rows[:: max(1, len(rows) // 16)]
    head = f"| step | {loss_col} |" if acc_col is None \
        else f"| step | {loss_col} | {acc_col} |"
    lines = ["", "## loss curve (sampled)", "", head,
             "|---|---|" if acc_col is None else "|---|---|---|"]
    for r in curve:
        if acc_col is None:
            lines.append(f"| {r.get('step', '?')} | {r['loss']:.4f} |")
        else:
            lines.append(f"| {r.get('step', '?')} | {r['loss']:.4f} | "
                         f"{r.get('clip_acc', float('nan')):.2f} |")
    lines.append("")
    return lines


def _write(path, lines):
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines))


_INTRO = ("Produced by `python -m avion_tpu_torch.tools.e2e_convergence "
          "--family {family}`: the port's `{entry}` entry in a child "
          "process, a mid-run SIGTERM preemption and an auto-resumed "
          "relaunch, then a held-out eval of the restored checkpoint.")


def _intro(family):
    return _INTRO.format(family=family, entry=_FAMILY_ENTRY[family])


def write_report(path, *, cfg, rows, resume_step, zs, wall_s):
    _write(path, [
        "# E2E convergence run (CLIP pretraining)", "", _intro("clip"), "",
        *_report_stats(cfg, rows, resume_step, wall_s, loss_label="loss",
                       acc_line=("clip_acc", "clip_acc")),
        f"- zero-shot held-out retrieval: top-1 {zs['zeroshot_top1']}, "
        f"top-5 {zs['zeroshot_top5']} over {zs['heldout_clips']} clips "
        f"(ckpt step {zs['ckpt_step']})",
        *([f"- the run's fresh init: top-1 {zs['init_zeroshot_top1']}, "
           f"top-5 {zs['init_zeroshot_top5']}"]
          if "init_zeroshot_top1" in zs else []),
        *_report_curve(rows, acc_col="clip_acc"),
    ])


def write_report_mae(path, *, cfg, rows, resume_step, zs, wall_s):
    _write(path, [
        "# E2E VideoMAE convergence run", "", _intro("videomae"), "",
        *_report_stats(cfg, rows, resume_step, wall_s,
                       loss_label="train MSE"),
        f"- held-out masked-reconstruction MSE: fresh init "
        f"{zs['mse_init']} -> trained {zs['mse_final']} "
        f"({zs['mse_ratio']:.2f}x, {zs['heldout_clips']} clips, "
        f"ckpt step {zs['ckpt_step']})",
        *_report_curve(rows, loss_col="mse"),
    ])


def write_report_cls(path, *, cfg, rows, resume_step, zs, wall_s):
    _write(path, [
        "# E2E classification-finetune convergence run", "", _intro("cls"),
        "",
        *_report_stats(cfg, rows, resume_step, wall_s,
                       loss_label="train loss",
                       acc_line=("train acc1 (mixup-soft targets)",
                                 "clip_acc")),
        f"- held-out eval (chance {zs['chance']}): top-1 {zs['top1']}, "
        f"top-{zs.get('topk_k', 5)} {zs.get('topk', zs.get('top5'))}, "
        f"verb top-1 {zs['verb_top1']}, noun top-1 "
        f"{zs['noun_top1']} over {zs['heldout_clips']} clips "
        f"(ckpt step {zs['ckpt_step']})",
        *_report_curve(rows, acc_col="acc1"),
    ])


def write_report_mir(path, *, cfg, rows, resume_step, zs, wall_s):
    _write(path, [
        "# E2E MIR-finetune convergence run", "", _intro("mir"), "",
        *_report_stats(cfg, rows, resume_step, wall_s,
                       loss_label="train loss"),
        f"- held-out sweep: {zs['heldout_clips']} clips, ckpt step "
        f"{zs['ckpt_step']}",
        *_init_vs_trained_lines(zs),
        *_report_curve(rows),
    ])


def write_report_nlq(path, *, cfg, rows, resume_step, zs, wall_s):
    _write(path, [
        "# E2E NLQ-grounding convergence run", "", _intro("nlq"), "",
        *_report_stats(cfg, rows, resume_step, wall_s,
                       loss_label="train loss"),
        f"- held-out sweep: {zs['val_queries']} queries, ckpt step "
        f"{zs['ckpt_step']}",
        *_init_vs_trained_lines(zs),
        *_report_curve(rows),
    ])


# per-family defaults for flags left unset (None)
_FAMILY_DEFAULTS = {
    # windows = caption windows per class (clip) / list repeats (mae)
    "clip": dict(model="CLIP_VITB16_H128", classes=32, windows=64,
                 batch=32, epochs=6, lr=1e-4, preempt_step=150),
    # the entry scales the mae base lr by batch / 256: 1.6e-2 * 16 / 256
    "videomae": dict(model="VIDEOMAE_VITB16_H128", classes=16, windows=64,
                     batch=16, epochs=3, lr=1.6e-2, preempt_step=80),
    # the entry scales the cls lr by batch / 128: 2e-3 * 16 / 128
    "cls": dict(model="CLIP_VITB16_H128", classes=16, windows=32,
                batch=16, epochs=6, lr=2e-3, preempt_step=60),
    "mir": dict(model="CLIP_VITB16_H128", classes=12, windows=32,
                batch=16, epochs=6, lr=1e-4, preempt_step=60),
    # nlq: classes = query concepts, windows = train samples per concept
    "nlq": dict(model="VSLNET", classes=8, windows=24,
                batch=16, epochs=20, lr=1e-3, preempt_step=80),
}


def default_out(family: str) -> str:
    return osp.join(tempfile.gettempdir(), f"avion_torch_e2e_{family}")


def default_report(out: str, family: str) -> str:
    return osp.join(out, f"E2E_{family}.md")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--family",
                   choices=("clip", "videomae", "cls", "mir", "nlq"),
                   default="clip")
    p.add_argument("--classes", type=int, default=None,
                   help="distinct seeded videos (clip: classes with "
                        "captions; videomae: videos)")
    p.add_argument("--windows", type=int, default=None)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--model", default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--workers", type=int,
                   default=max(1, (os.cpu_count() or 1) - 1))
    p.add_argument("--preempt-step", type=int, default=None,
                   help="send SIGTERM once this step is logged; "
                        "0 disables the preemption drill")
    p.add_argument("--out", default=None)
    p.add_argument("--report", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--timeout", type=float, default=3600,
                   help="seconds a training child may run")
    p.add_argument("--stall-timeout", type=float, default=900,
                   help="seconds a training child may go without a step")
    p.add_argument("--extra", nargs="*", default=[],
                   help="extra section.key=value overrides for the entry")
    args = p.parse_args(argv)

    from avion_tpu_torch.ops.flash_attention import (launches, plain_calls,
                                                     reset_launches)
    from avion_tpu_torch.parallel.launch import resolve_device

    device = resolve_device(args.device)
    for k, v in _FAMILY_DEFAULTS[args.family].items():
        if getattr(args, k) is None:
            setattr(args, k, v)
    args.out = args.out or default_out(args.family)
    args.report = args.report or default_report(args.out, args.family)

    t0 = time.monotonic()
    root = osp.join(args.out, "data")
    run_dir = osp.join(args.out, "run")
    counts_dir = osp.join(args.out, "kernel_counts")
    os.makedirs(run_dir, exist_ok=True)
    os.makedirs(counts_dir, exist_ok=True)
    ts = time.monotonic()
    maker = {"clip": make_class_dataset, "cls": make_cls_dataset,
             "mir": make_mir_dataset, "nlq": make_nlq_dataset,
             "videomae": make_mae_dataset}[args.family]
    meta = maker(root, args.classes, args.windows)
    print(f"[e2e] dataset ready in {time.monotonic() - ts:.0f}s",
          file=sys.stderr)

    log_path = osp.join(args.out, "train_stdout.log")
    common = dict(model=args.model, batch=args.batch, epochs=args.epochs,
                  workers=args.workers, lr=args.lr, log_path=log_path,
                  extra=tuple(args.extra), family=args.family,
                  device=device, counts_dir=counts_dir,
                  timeout_s=args.timeout, stall_timeout_s=args.stall_timeout)

    def launch_with_relaunch(phase, **kw):
        # a stalled child is killed and relaunched; auto-resume continues
        for attempt in range(3):
            try:
                return launch_training(root, meta, run_dir, **common, **kw)
            except TrainingStalled as e:
                print(f"[e2e] {phase} attempt {attempt + 1} stalled "
                      f"({e}); relaunching", file=sys.stderr)
        raise RuntimeError(f"{phase} stalled on every attempt")

    t_train = time.monotonic()
    resume_step = 0
    if args.preempt_step:
        # phase A: train until the preemption drill fires
        rc = launch_with_relaunch(
            "phase A", preempt_after_steps=args.preempt_step)
        print(f"[e2e] phase A (preempted) rc={rc}", file=sys.stderr)
        resume_step = _last_step(osp.join(run_dir, "log.jsonl"))
    # phase B: the same command, which auto-resumes to the end
    rc = launch_with_relaunch("phase B")
    if rc != 0:
        raise RuntimeError(f"phase B failed rc={rc}; see {log_path}")
    print(f"[e2e] phase B (resumed from ~step {resume_step}) rc={rc}",
          file=sys.stderr)
    train_s = time.monotonic() - t_train

    rows = read_log(run_dir, acc_key=("train/acc1" if args.family == "cls"
                                      else "train/clip_acc"))
    reset_launches()
    if args.family == "clip":
        zs = zero_shot_sweep(root, run_dir, batch=args.batch,
                             n_classes=args.classes, device=device)
    elif args.family == "cls":
        zs = cls_eval(root, run_dir, batch=args.batch,
                      n_classes=args.classes, device=device)
    elif args.family == "mir":
        zs = mir_eval(root, run_dir, batch=args.batch, device=device)
    elif args.family == "nlq":
        zs = nlq_eval(root, run_dir, batch=args.batch, device=device)
    else:
        zs = mae_eval(root, run_dir, batch=args.batch,
                      n_videos=args.classes, device=device)
    eval_counts = {"launches": dict(launches),
                   "plain_calls": dict(plain_calls)}
    train_counts = read_counts(counts_dir)
    cfg = {"family": args.family, "model": args.model,
           "classes": args.classes, "windows_per_class": args.windows,
           "batch": args.batch, "epochs": args.epochs, "lr": args.lr,
           "workers": args.workers, "preempt_step": args.preempt_step,
           "device": str(device), "card": card_info(device)}
    if args.extra:  # entry overrides are part of the recorded recipe
        cfg["extra"] = list(args.extra)
    report = {"clip": write_report, "videomae": write_report_mae,
              "cls": write_report_cls, "mir": write_report_mir,
              "nlq": write_report_nlq}[args.family]
    report(args.report, cfg=cfg, rows=rows, resume_step=resume_step,
           zs=zs, wall_s=time.monotonic() - t0)
    # NLQ's batch counts queries; the others' count clips
    summary = {"metric": f"e2e_convergence_{args.family}", **cfg,
               "steps_logged": len(rows),
               "resume_step": resume_step,
               "first_loss": rows[0]["loss"] if rows else None,
               "final_loss": rows[-1]["loss"] if rows else None,
               "train_s": round(train_s, 3),
               "samples_per_s": round(zs["ckpt_step"] * args.batch / train_s,
                                      3),
               "wall_s": round(time.monotonic() - t0, 3),
               "launches": {"train": train_counts["launches"],
                            "eval": eval_counts["launches"]},
               "plain_calls": {"train": train_counts["plain_calls"],
                               "eval": eval_counts["plain_calls"]},
               "report": args.report, **zs}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
