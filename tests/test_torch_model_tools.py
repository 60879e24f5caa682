"""The port's model tools against the JAX package's:
``tools.convert_checkpoint`` (``import`` writes the JAX tool's ``.npz``
key for key and value for value on the layouts of
``tests/test_torch_convert.py``; ``export`` of a port checkpoint directory
writes what ``export_clip_to_pt`` writes of the same weights, plus
``logit_bias``; a missing leaf raises), ``core.flops`` (equal FLOPs, MFU
at 989 TFLOP/s), ``core.profiling`` on the CPU, and
``tools.profile_step.analyze_trace`` on a chrome trace in torch's format
written here."""

import gzip
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avion_tpu.core import flops as jax_flops
from avion_tpu.models.registry import create_model as jax_create_model
from avion_tpu.tools import convert_checkpoint as jax_convert
from avion_tpu_torch.core import flops, profiling
from avion_tpu_torch.core.checkpoint import Checkpointer
from avion_tpu_torch.models.pt_import import params_from_jax
from avion_tpu_torch.models.registry import create_model
from avion_tpu_torch.tools import convert_checkpoint, profile_step
from test_torch_convert import _reference_variant

FRAMES = 2


def _flax_params(seed, **kw):
    jm = jax_create_model("CLIP_TINY", num_frames=FRAMES, **kw)
    params = jax.jit(jm.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, FRAMES, 32, 32, 3)),
        jnp.zeros((1, 77), jnp.int32))["params"]
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rs.standard_normal(np.shape(x)).astype(np.float32), params)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    params = _flax_params(0)
    path = str(tmp_path_factory.mktemp("pt") / "clip.pt")
    jax_convert.export_clip_to_pt(params, path)
    return params, path


@pytest.fixture(scope="module")
def jax_npz(exported):
    """The JAX tool's ``import`` as its ``main`` runs it: the flattened
    merge of ``import_clip_pt`` into a template of the model's leaves,
    ``strict=False`` (``main`` draws its template with an unjitted
    ``model.init``, seconds op by op; the exported tree has the same
    leaves)."""
    from avion_tpu.models.pt_import import import_clip_pt, merge_into_params

    template = exported[0]

    def run(src, dst):
        imported = import_clip_pt(src, num_frames=FRAMES, context_length=77,
                                  vocab_size=49408)
        np.savez(dst, **jax_convert.flatten_params(merge_into_params(
            template, imported, strict=False)))

    return run


def _args(direction, src, dst):
    return [direction, "--src", src, "--dst", dst, "--model", "CLIP_TINY",
            "--frames", str(FRAMES)]


@pytest.mark.parametrize("layout", ["export", "in_proj", "openai"])
def test_import_writes_jax_npz(exported, jax_npz, tmp_path, layout):
    _, src = exported
    if layout != "export":
        sd = torch.load(src, map_location="cpu")["state_dict"]
        src = str(tmp_path / "variant.pt")
        torch.save({"state_dict": _reference_variant(
            sd, layout == "openai")}, src)
    jax_npz(src, str(tmp_path / "jax.npz"))
    convert_checkpoint.main(_args("import", src, str(tmp_path / "port.npz")))
    ref, got = (np.load(tmp_path / f"{w}.npz") for w in ("jax", "port"))
    assert sorted(got.files) == sorted(ref.files)
    for k in ref.files:
        assert got[k].dtype == ref[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_flax_params_from_state_inverts_params_from_jax(exported):
    params, _ = exported
    sd = params_from_jax(params)
    flat = convert_checkpoint.flax_params_from_state(sd)
    want = jax_convert.flatten_params(params)
    assert sorted(flat) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("drop", ["visual.transformer.resblocks.1.",
                                  "text_projection",
                                  "visual.temporal_embedding"])
def test_import_names_a_missing_leaf(exported, jax_npz, tmp_path, drop):
    """The JAX tool fills a leaf the file lacks (a block, a projection,
    the temporal table) from flax's random init; the port raises and
    names it."""
    sd = torch.load(exported[1], map_location="cpu")["state_dict"]
    sd = {k: v for k, v in sd.items() if not k.startswith(drop)}
    src = str(tmp_path / "partial.pt")
    torch.save({"state_dict": sd}, src)
    jax_npz(src, str(tmp_path / "jax.npz"))  # no error there
    with pytest.raises(KeyError, match=drop.replace(".", r"\.")):
        convert_checkpoint.main(_args("import", src,
                                      str(tmp_path / "port.npz")))


class _State:
    def __init__(self, sd):
        self.sd = sd

    def state_dict(self):
        return {"step": 7, "model": self.sd, "optimizer": {}}


@pytest.mark.parametrize("logit_bias", [False, True])
def test_export_of_a_checkpoint_dir_as_jax(tmp_path, logit_bias):
    """A port checkpoint directory (the newest of two steps) -> the
    reference ``.pt``: the keys and values of ``export_clip_to_pt`` of
    the same weights, and ``logit_bias``, which the JAX export drops."""
    params = _flax_params(1, use_logit_bias=logit_bias)
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    stale = {k: torch.zeros_like(v) for k, v in params_from_jax(
        params).items()}
    ckpt.save(3, _State(stale))
    ckpt.save(7, _State(params_from_jax(params)))
    port_pt, jax_pt = str(tmp_path / "port.pt"), str(tmp_path / "jax.pt")
    convert_checkpoint.main(_args("export", str(tmp_path), port_pt))
    jax_convert.export_clip_to_pt(params, jax_pt)
    got = torch.load(port_pt, map_location="cpu")["state_dict"]
    ref = torch.load(jax_pt, map_location="cpu")["state_dict"]
    extra = {"logit_bias"} if logit_bias else set()
    assert set(got) == set(ref) | extra and not set(ref) & extra
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0, msg=k)
    model = create_model("CLIP_TINY", num_frames=FRAMES,
                         use_logit_bias=logit_bias)
    model.load_state_dict(got, strict=True)


def test_export_of_a_pt_and_a_missing_leaf(exported, tmp_path):
    params, src = exported
    dst = str(tmp_path / "out.pt")
    convert_checkpoint.main(_args("export", src, dst))
    got = torch.load(dst, map_location="cpu")["state_dict"]
    ref = torch.load(src, map_location="cpu")["state_dict"]
    assert set(got) == set(ref)
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0, msg=k)
    del ref["visual.ln_post.bias"]
    torch.save({"state_dict": ref}, src.replace("clip.pt", "part.pt"))
    with pytest.raises(KeyError, match="visual.ln_post.bias"):
        convert_checkpoint.main(_args(
            "export", src.replace("clip.pt", "part.pt"), dst))


@pytest.mark.parametrize("geom", [
    {}, dict(clip_len=16), dict(image=336, patch=14, vw=1024, vl=24),
    dict(clip_len=8, tw=768, tl=12, ctx=32), dict(image=32, patch=16, vw=64,
                                                  vl=2, tw=32, tl=2),
])
def test_clip_fwd_flops_and_mfu_as_jax(geom):
    f = flops.clip_fwd_flops(**geom)
    assert f == jax_flops.clip_fwd_flops(**geom) > 0
    assert flops.H100_PEAK_FLOPS == 989e12
    assert flops.mfu(123.0, f) == pytest.approx(
        jax_flops.mfu(123.0, f, peak=989e12), rel=1e-12)
    assert not hasattr(flops, "V5E_PEAK_FLOPS")


def test_profiling_trace_span_on_cpu(tmp_path):
    model = create_model("CLIP_TINY", num_frames=FRAMES).eval()
    with profiling.trace(str(tmp_path / "tr")) as path:
        with torch.no_grad(), profiling.span("outer"):
            model.encode_image(torch.zeros(1, FRAMES, 32, 32, 3))
            model.encode_text(torch.zeros(1, 77, dtype=torch.long))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"outer", "avion.tower.visual", "avion.tower.text"} <= names
    rows, total = profile_step.analyze_trace(str(tmp_path / "tr"))
    assert rows == [] and total == 0.0  # the CPU has no device events


def _ev(cat, name, pid, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _step_events(t0, corr0):
    """One step: a forward on the main thread (1, 1) in two towers, an
    optimizer copy outside both, a backward on the autograd thread (1, 2)
    whose first node's sequence number points into the vision tower; the
    device (0, 7) runs one event per launch."""
    c = lambda i: corr0 + i  # noqa: E731
    host = [
        _ev("user_annotation", "avion.tower.visual", 1, 1, t0, 100),
        _ev("cpu_op", "aten::mm", 1, 1, t0 + 10, 10, **{"Sequence number":
                                                        t0 + 5}),
        _ev("cuda_runtime", "cudaLaunchKernel", 1, 1, t0 + 12, 2,
            correlation=c(1)),
        _ev("cuda_runtime", "cudaLaunchKernelExC", 1, 1, t0 + 50, 2,
            correlation=c(2)),
        _ev("user_annotation", "avion.tower.text", 1, 1, t0 + 200, 100),
        _ev("cuda_runtime", "cudaLaunchKernelExC", 1, 1, t0 + 210, 2,
            correlation=c(3)),
        _ev("cuda_runtime", "cudaMemcpyAsync", 1, 1, t0 + 400, 2,
            correlation=c(4)),
        _ev("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 1,
            2, t0 + 500, 100, **{"Sequence number": t0 + 5}),
        _ev("cpu_op", "aten::mm", 1, 2, t0 + 505, 50,
            **{"Sequence number": t0 + 5}),
        _ev("cuda_runtime", "cudaLaunchKernel", 1, 2, t0 + 510, 2,
            correlation=c(5)),
        _ev("cpu_op", "autograd::engine::evaluate_function: FlashBackward",
            1, 2, t0 + 650, 50, **{"Sequence number": t0 + 99}),
        _ev("cuda_runtime", "cudaLaunchKernelExC", 1, 2, t0 + 660, 2,
            correlation=c(6)),
        _ev("cuda_runtime", "cudaMemsetAsync", 1, 2, t0 + 670, 2,
            correlation=c(7)),
    ]
    dev = [
        ("kernel", "nvjet_tst_128x64_TNT", 1, 20),
        ("kernel", "void (anonymous namespace)::flash_fwd_kernel<64, false, "
         "1>(CUtensorMap)", 2, 40),
        ("kernel", "void flash_fwd_kernel<64, true, 1>(CUtensorMap)", 3, 30),
        ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 4, 8),
        ("kernel", "nvjet_tst_128x64_TNT", 5, 60),
        ("kernel", "void at::native::(anonymous namespace)::bwd_kv_kernel<64,"
         " true>(CUtensorMap)", 6, 90),
        ("gpu_memset", "Memset (Device)", 7, 4),
    ]
    return host + [_ev(cat, name, 0, 7, t0 + 1000 + i, dur,
                       correlation=c(i), device=0, stream=7)
                   for cat, name, i, dur in dev]


def test_analyze_trace_rows(tmp_path):
    evs = [{"ph": "M", "name": "process_name", "pid": 0,
            "args": {"name": "GPU 0"}}]
    for step in range(2):
        evs += _step_events(step * 10000, step * 100)
    d = tmp_path / "trace" / "nested"
    d.mkdir(parents=True)
    (tmp_path / "trace" / "old.json").write_text(json.dumps(
        {"traceEvents": []}))
    os.utime(tmp_path / "trace" / "old.json", (0, 0))
    with gzip.open(d / "t.pt.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": evs}, f)
    rows, total = profile_step.analyze_trace(str(tmp_path / "trace"),
                                             top=25, steps=2)
    got = {(kind, region, phase): (ms, n) for ms, n, kind, region, phase
           in rows}
    assert got == {
        ("bwd_kv_kernel", "other", "bwd"): (0.09, 1),
        ("nvjet_tst_128x64_TNT", "vision", "bwd"): (0.06, 1),
        ("flash_fwd_kernel", "vision", "fwd"): (0.04, 1),
        ("flash_fwd_kernel", "text", "fwd"): (0.03, 1),
        ("nvjet_tst_128x64_TNT", "vision", "fwd"): (0.02, 1),
        ("Memcpy HtoD", "other", "fwd"): (0.008, 1),
        ("Memset", "other", "bwd"): (0.004, 1)}
    assert [r[0] for r in rows] == sorted((r[0] for r in rows), reverse=True)
    assert total == pytest.approx(0.252)
    top, _ = profile_step.analyze_trace(str(tmp_path / "trace"), top=2,
                                        steps=2)
    assert top == rows[:2]


def test_profile_step_main_trace_only(tmp_path, capsys):
    (tmp_path / "t.json").write_text(json.dumps(
        {"traceEvents": _step_events(0, 0)}))
    out = profile_step.main(["--trace-only", str(tmp_path), "--steps", "1"])
    text = capsys.readouterr().out
    assert "device op time: 0.3 ms/step" in text and "bwd_kv_kernel" in text
    assert out["wall_ms"] is None and len(out["rows"]) == 7


def test_profile_step_capture_on_cpu(tmp_path, capsys):
    """The capture path end to end on the CPU at a tiny size: three
    warm-up steps and the traced ones (no device rows there)."""
    out = profile_step.main(["--model", "CLIP_TINY", "--frames", "2",
                             "--batch", "2", "--steps", "1", "--device",
                             "cpu", "--out", str(tmp_path)])
    assert out["wall_ms"] > 0 and out["rows"] == []
    assert "device op time" in capsys.readouterr().out


def test_profile_step_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        profile_step.main(["--model", "CLIP_TINY", "--out", str(tmp_path)])
