"""Dataset metadata parsers (``avion_tpu.data.metadata``).

The on-disk formats the reference consumes:

- ego4d: pickle of (video_uid, start_s, end_s, narration[, ...]) rows
- ego4d_mcq: json of {idx: {query, choices{...}, answer, types}}
- ek100_cls / ek100_mir: EPIC-Kitchens csv (+ _sentence.csv and
  relevancy pickles for MIR)
- egtea: split txt + action_idx.txt (+ cached video_len_dict.pkl)
- charades_ego: csv with action tuples "cXXX start end;..."
- kinetics/k400 lists: "path [num_frames] label" lines or csv

No ``pandas``: the MIR sentence table is read with the ``csv`` module
into a list of rows.
"""

from __future__ import annotations

import csv
import glob
import json
import os.path as osp
import pickle
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def datetime2sec(ts: str) -> float:
    """'HH:MM:SS.xx' -> seconds."""
    hh, mm, ss = ts.split(":")
    return int(hh) * 3600 + int(mm) * 60 + float(ss)


@dataclass
class Sample:
    vid: str
    start: float  # seconds (or frames for frame-addressed datasets)
    end: float
    caption: Any = None
    label: Any = None
    fps: float = 30.0
    verb: int = -1
    noun: int = -1


def load_ego4d(metadata: str) -> List[Sample]:
    with open(metadata, "rb") as f:
        rows = pickle.load(f)
    out = []
    for row in rows:
        vid, start, end, narration = row[:4]
        out.append(Sample(vid=vid, start=float(start), end=float(end),
                          caption=narration))
    return out


def load_ego4d_mcq(metadata: str) -> Dict[str, Any]:
    with open(metadata) as f:
        return json.load(f)


def _video_fps_dict(root: str, pattern: str, chunked: bool,
                    cache_path: Optional[str] = None) -> Dict[str, float]:
    from avion_tpu_torch.data.video_reader import VideoReader

    if cache_path and osp.exists(cache_path):
        with open(cache_path, "rb") as f:
            return pickle.load(f)
    fps = {}
    for video in glob.glob(osp.join(root, pattern)):
        probe = osp.join(video, "0.MP4") if chunked else video
        try:
            fps[video] = VideoReader(probe).get_avg_fps()
        except Exception:
            fps[video] = 30.0
    if cache_path:
        try:
            with open(cache_path, "wb") as f:
                pickle.dump(fps, f)
        except OSError:
            pass
    return fps


def load_ek100(
    root: str, metadata: str, default_fps: float = 50.0
) -> List[Sample]:
    """EPIC-Kitchens-100 csv.  Video files are chunked dirs
    ``root/PXX/PXX_YY.MP4/<n>.MP4``; fps probed from chunk 0 when
    present."""
    fps_dict = _video_fps_dict(root, "*/*.MP4", chunked=True)
    out = []
    with open(metadata) as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            pid, vid = row[1:3]
            start, end = datetime2sec(row[4]), datetime2sec(row[5])
            narration = row[8]
            verb, noun = int(row[10]), int(row[12])
            vid_path = f"{pid}/{vid}"
            fps = fps_dict.get(osp.join(root, vid_path + ".MP4"), default_fps)
            out.append(Sample(vid=vid_path, start=start, end=end,
                              caption=narration, fps=fps, verb=verb,
                              noun=noun))
    return out


def load_ek100_mir_extras(metadata: str):
    """(sentence rows, relevancy matrix, threshold) for MIR.  The
    sentence table is the ``_sentence.csv`` beside ``metadata`` without
    its header row and blank lines: ``sentences[j][1]`` is the narration
    of sentence ``j``."""
    path = metadata[: metadata.rindex(".csv")] + "_sentence.csv"
    with open(path, newline="") as f:
        rows = [row for row in csv.reader(f) if row]
    sentences = rows[1:]
    split = "train" if "train" in osp.basename(metadata) else "test"
    rel_path = osp.join(
        osp.dirname(metadata), "relevancy",
        f"caption_relevancy_EPIC_100_retrieval_{split}.pkl",
    )
    with open(rel_path, "rb") as f:
        relevancy = pickle.load(f)
    return sentences, relevancy, 0.1


def load_egtea(root: str, metadata: str) -> Tuple[List[Sample], List[str]]:
    """(samples, label list)."""
    from avion_tpu_torch.data.video_reader import VideoReader

    len_dict_path = osp.join(osp.dirname(metadata), "video_len_dict.pkl")
    if osp.exists(len_dict_path):
        with open(len_dict_path, "rb") as f:
            len_dict = pickle.load(f)
    else:
        len_dict = {}
        for video in glob.glob(osp.join(root, "*/*")):
            try:
                len_dict[video] = len(VideoReader(video))
            except Exception:
                pass
        try:
            with open(len_dict_path, "wb") as f:
                pickle.dump(len_dict, f)
        except OSError:
            pass

    labels = []
    vn_to_label = {}
    for row in open(osp.join(osp.dirname(metadata), "action_idx.txt")):
        row = row.strip()
        vn = int(row.split(" ")[-1])
        narration = " ".join(row.split(" ")[:-1]).replace("_", " ").lower()
        vn_to_label[vn] = narration
        labels.append(narration)

    samples = []
    for row in open(metadata):
        clip_id, action_idx = row.strip().split(" ")[:2]
        video_id = "-".join(clip_id.split("-")[:3])
        rel = osp.join(video_id, f"{clip_id}.mp4")
        full = osp.join(root, rel)
        samples.append(Sample(
            vid=rel, start=0, end=len_dict.get(full, 0),
            caption=vn_to_label[int(action_idx)], label=int(action_idx) - 1,
        ))
    return samples, labels


def load_charades_ego(
    root: str, metadata: str, is_trimmed: bool = True
) -> List[Sample]:
    fps_dict = _video_fps_dict(
        root, "*.mp4", chunked=False,
        cache_path=osp.join(osp.dirname(metadata), "fps_dict.pkl"),
    )
    out = []
    with open(metadata) as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            video_id = row[0]
            vid_path = f"{video_id}.mp4"
            fps = fps_dict.get(osp.join(root, vid_path), 30.0)
            if is_trimmed:
                for action_tuple in row[9].split(";"):
                    if not action_tuple:
                        continue
                    action, start_ts, end_ts = action_tuple.split(" ")
                    out.append(Sample(
                        vid=vid_path,
                        start=int(np.round(fps * float(start_ts))),
                        end=int(np.ceil(fps * float(end_ts))),
                        label=action, fps=fps,
                    ))
            else:
                actions = (
                    [t.split(" ")[0] for t in row[9].split(";")]
                    if row[9] else []
                )
                out.append(Sample(
                    vid=vid_path, start=0, end=fps * float(row[10]),
                    label=actions, fps=fps,
                ))
    return out


def load_video_list(metadata: str) -> List[Sample]:
    """Kinetics-style lists: 'path[,| ]label' or 'path num_frames label'."""
    out = []
    for line in open(metadata):
        line = line.strip()
        if not line:
            continue
        parts = line.split(",") if "," in line else line.split()
        if len(parts) == 2:
            path, label = parts
            out.append(Sample(vid=path, start=0, end=-1, label=int(label)))
        else:
            path, n_frames, label = parts[0], parts[1], parts[2]
            out.append(Sample(vid=path, start=0, end=int(n_frames),
                              label=int(label)))
    return out


def generate_label_map(dataset: str, paths: Dict[str, str]) -> List[str]:
    """Class-label text lists for zero-shot heads; ``paths`` carries the
    file locations the reference reads from env vars."""
    if dataset == "ek100_cls":
        labels = []
        with open(paths["actions_csv"]) as f:
            reader = csv.reader(f)
            next(reader)
            for row in reader:
                labels.append(row[3].replace("_", " "))
        return labels
    if dataset == "charades_ego":
        labels = []
        for line in open(paths["classes_txt"]):
            labels.append(line.strip()[5:])
        return labels
    if dataset == "egtea":
        labels = []
        for row in open(paths["action_idx"]):
            narration = " ".join(row.strip().split(" ")[:-1])
            labels.append(narration.replace("_", " ").lower())
        return labels
    raise NotImplementedError(dataset)
