"""A small copy of the benchmark's data on the CPU: the same traffic files
at a few rows of 32-pixel clips, configurations at the port's ``CLIP_TINY``
and ``VIDEOMAE_TINY`` widths, and limits for their f32 towers.  Its
``BENCHMARK.json`` names one tiny cell per real one."""

from __future__ import annotations

import json
import os

import pytest

from portbench import cells

TINY_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3,
               "grad_gap_median": 1e-4, "change_gap_median": 1e-4}
TINY_CELLS = {
    "clip_tiny.pretrain": ("clip_tiny", "pretrain_4f_b256"),
    "clip_tiny.mir": ("clip_tiny", "mir_16f_b64"),
    "videomae_tiny.pretrain": ("videomae_tiny", "pretrain_16f_b128"),
}
# each tiny cell stands for the real one of its traffic
REAL = {"clip_tiny.pretrain": "clip_vitb16.pretrain_4f_b256",
        "clip_tiny.mir": "clip_vitb16.mir_16f_b64",
        "videomae_tiny.pretrain": "videomae_vitb16.pretrain_16f_b128"}


def _write(root: str, name: str, obj: dict) -> None:
    path = os.path.join(root, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def write_tiny_root(root: str) -> str:
    data = cells.BENCH_DIR
    bench = cells.read_json(os.path.join(cells.ROOT, "BENCHMARK.json"))
    clip = cells.read_json(os.path.join(data, "configs", "clip_vitb16.json"))
    clip.update(port_model="CLIP_TINY", image_size=32, vision_width=64,
                vision_layers=2, vision_heads=2, text_width=32,
                text_layers=2, text_heads=2, embed_dim=32)
    mae = cells.read_json(os.path.join(data, "configs",
                                       "videomae_vitb16.json"))
    mae.update(port_model="VIDEOMAE_TINY", image_size=32, num_frames=4,
               encoder_width=48, encoder_layers=1, encoder_heads=2,
               decoder_width=32, decoder_layers=1, decoder_heads=2,
               mask_ratio=0.5)
    _write(root, "portbench/configs/clip_tiny.json", clip)
    _write(root, "portbench/configs/videomae_tiny.json", mae)
    for _, traffic in TINY_CELLS.values():
        t = cells.read_json(os.path.join(data, "traffic", f"{traffic}.json"))
        t.update(batch=8, video={"frames": 4 if "16f" in traffic else 2,
                                 "size": 32},
                 reference={"block": 4})
        _write(root, f"portbench/traffic/{traffic}.json", t)
    for name in TINY_CELLS:
        _write(root, f"portbench/limits/{name}.json", TINY_LIMITS)
    tiny = dict(bench)
    tiny["configs"] = [
        {"name": n, "source": "test", "file": f"portbench/configs/{n}.json",
         "reduced": [], "why": "test"} for n in ("clip_tiny", "videomae_tiny")]
    tiny["workloads"] = [
        {"name": name, "config": c, "traffic": t, "chips": 1, "why": "test"}
        for name, (c, t) in TINY_CELLS.items()]
    for kind in ("end_to_end", "per_layer"):
        tiny[kind] = []
        for m in bench[kind]:
            m = dict(m)
            if "workloads" in m:
                m["workloads"] = [t for t, r in REAL.items()
                                  if r in m["workloads"]]
            tiny[kind].append(m)
    _write(root, "BENCHMARK.json", tiny)
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> str:
    return write_tiny_root(str(tmp_path_factory.mktemp("tiny_bench")))
