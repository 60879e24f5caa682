"""The port's benchmark tools (``avion_tpu_torch.tools.bench_*``,
``mxu_roofline``) against the JAX package's: ``bench_pipeline``'s
synthetic dataset (the same metadata and the same files), its
``--host-cores`` projection (the JAX main's formula), ``bench_vitl``'s
model FLOPs and ``mxu_roofline``'s bounds (the flops and bytes counted
by hand); each tool's ``main`` at a tiny size with ``--device cpu``
prints one JSON line that carries the JAX tool's keys; and each ``main``
without CUDA and without ``--device cpu`` raises rather than run on the
CPU.  (``headdim_ablation``: ``tests/test_torch_headdim_ablation.py``.)"""

import json
import os
import os.path as osp
import pickle

import pytest
import torch

from avion_tpu.tools import bench_pipeline as jax_pipeline
from avion_tpu.tools import bench_vitl as jax_vitl
from avion_tpu_torch.tools import (bench_attention, bench_narrator,
                                   bench_pipeline, bench_serve,
                                   bench_videomae, bench_vitl,
                                   headdim_ablation, mxu_roofline)

# the keys of each JAX tool's JSON line (avion_tpu/tools/<tool>.py)
JAX_KEYS = {
    "bench_attention": {"metric", "split_ms", "combined_ms", "speedup"},
    "mxu_roofline": {"metric", "shape", "12x64", "6x128",
                     "fwd_12x64_over_6x128", "fwdbwd_12x64_over_6x128"},
    "bench_vitl": {"metric", "value", "unit", "mfu", "step_ms"},
    "bench_videomae": {"metric", "value", "unit", "vs_baseline"},
    "bench_pipeline": {"metric", "input_path", "value", "unit",
                       "duty_cycle", "data_time_s", "step_time_s",
                       "decode_clips_per_sec_per_core", "host_cores",
                       "live_batch", "projected_duty_cycle_at_cores",
                       "loss"},
    "bench_serve": {"metric", "text_embeds_per_sec",
                    "video_embeds_per_sec", "unit", "text_mean_batch",
                    "video_mean_batch", "text_p95_ms", "video_p95_ms",
                    "device"},
    "bench_narrator": {"metric", "value", "unit", "tokens_per_sec",
                       "batch_s", "samples_per_clip", "kv_cache"},
    "headdim_ablation": {"metric", "seed", "arms", "top1_delta_vs_first",
                         "loss_delta_vs_first"},
}
MXU_ARM_KEYS = {"fwd_ms", "fwdbwd_ms", "fwd_tflops"}
ARM_KEYS = {"heads", "head_dim", "first_loss", "final_loss",
            "final_clip_acc", "heldout_top1"}


def _listing(root):
    return sorted(osp.relpath(osp.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_chunked_dataset_matches_jax(tmp_path):
    """The same metadata (video, window, caption) and the same files."""
    kw = dict(n_videos=2, chunk_len=3, fps=10, w=64, h=48)
    metas = []
    for name, mod in (("jax", jax_pipeline), ("port", bench_pipeline)):
        root = str(tmp_path / name)
        metas.append(mod.make_chunked_dataset(root, **kw))
    with open(metas[0], "rb") as f:
        want = pickle.load(f)
    with open(metas[1], "rb") as f:
        got = pickle.load(f)
    assert got == want and len(got) == 16
    assert _listing(str(tmp_path / "port")) == _listing(
        str(tmp_path / "jax"))
    assert len(_listing(str(tmp_path / "port"))) == 2 * 2 + 1


@pytest.mark.parametrize("batch,step_s,rate,cores",
                         [(64, 0.5, 3.0, 112), (64, 0.05, 2.5, 96),
                          (8, 0.0, 0.0, 1)])
def test_host_cores_projection_matches_jax(batch, step_s, rate, cores):
    """The JAX main's projection (``bench_pipeline.py``, after
    ``live_segment``): supply = cores x per-core rate against demand =
    batch / step time, capped at 1."""
    demand = batch / max(step_s or 1e-9, 1e-9)
    want = min(1.0, cores * rate / max(demand, 1e-9))
    assert bench_pipeline.projected_duty_cycle(batch, step_s, rate,
                                               cores) == want


def test_vitl_model_flops_match_jax():
    assert bench_vitl.model_fwd_flops() == jax_vitl.model_fwd_flops()


@pytest.mark.parametrize("b,s,h,d", [(256, 785, 12, 64),
                                     (256, 785, 6, 128), (4, 17, 12, 64)])
def test_roofline_bounds(b, s, h, d):
    """The forward: 2 S x S x D products a head, qkv read and out written
    (4 [B, S, 768] bf16 tensors); forward + backward: 7 products, qkv and
    the output's gradient read, out and qkv's gradient written (8); the
    larger of the flops at 989 TFLOP/s and the bytes at 3.35 TB/s."""
    got = mxu_roofline.bounds(b, s, h, d)
    for key, products, tensors in (("fwd", 2, 4), ("fwdbwd", 7, 8)):
        t_ops = 2 * products * b * h * s * s * d / 989e12
        t_bytes = tensors * b * s * h * d * 2 / 3.35e12
        assert got[f"{key}_bound_ms"] == pytest.approx(
            max(t_ops, t_bytes) * 1e3, rel=1e-12)
        assert got[f"{key}_bound_by"] == ("operations" if t_ops > t_bytes
                                          else "bytes")
    # S 785 is well above the ridge, S 17 well below
    assert got["fwd_bound_by"] == ("operations" if s > 100 else "bytes")


TINY = {
    "bench_attention": ["--batch", "2", "--frames", "1", "--grid", "4",
                        "--width", "128", "--heads", "2", "--iters", "1"],
    "mxu_roofline": ["--batch", "1", "--seq", "17", "--iters", "1"],
    "bench_vitl": ["2", "--model", "CLIP_TINY"],
    "bench_videomae": ["2", "--model", "VIDEOMAE_TINY"],
    "bench_pipeline": ["--model", "CLIP_TINY", "--batch", "4", "--steps",
                       "2", "--videos", "2", "--workers", "1",
                       "--clip-length", "2", "--crop-size", "32"],
    "bench_serve": ["--model", "CLIP_TINY", "--frames", "2", "--texts", "4",
                    "--videos", "2", "--threads", "2", "--weights", "int8"],
    "bench_narrator": ["--batch", "2", "--max-len", "4"],
    "headdim_ablation": ["--steps", "2", "--batch", "4", "--concepts", "4",
                         "--width", "64", "--layers", "1", "--frames", "2",
                         "--size", "32", "--heads", "2", "1"],
}
TOOLS = {"bench_attention": bench_attention, "mxu_roofline": mxu_roofline,
         "bench_vitl": bench_vitl, "bench_videomae": bench_videomae,
         "bench_pipeline": bench_pipeline, "bench_serve": bench_serve,
         "bench_narrator": bench_narrator,
         "headdim_ablation": headdim_ablation}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_main_on_cpu_prints_the_jax_keys(tool, tmp_path, monkeypatch,
                                              capsys):
    args = TINY[tool] + ["--device", "cpu"]
    if tool == "bench_pipeline":
        args += ["--root", str(tmp_path / "pipe")]
    if tool == "bench_narrator":  # GPT-2-medium's init alone takes seconds
        monkeypatch.setitem(bench_narrator.GEOMETRIES, False, (32, 3, 2))
    out = TOOLS[tool].main(args)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert JAX_KEYS[tool] <= set(line), JAX_KEYS[tool] - set(line)
    if tool == "mxu_roofline":
        for arm in ("12x64", "6x128"):
            assert MXU_ARM_KEYS | {"fwd_bound_ms", "sdpa_fwd_ms"} <= set(
                line[arm])
    if tool == "headdim_ablation":
        assert [a["head_dim"] for a in line["arms"]] == [32, 64]
        for arm in line["arms"]:
            assert ARM_KEYS <= set(arm)
    if tool == "bench_vitl":
        assert line["mfu"] is None  # no share of the card's peak on a CPU
    if tool == "bench_pipeline":
        assert line["decode_backend"] in ("native", "cv2")


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_main_without_cuda_raises(tool, monkeypatch):
    """The default device is CUDA: without it a tool refuses to run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TOOLS[tool].main(TINY[tool])
