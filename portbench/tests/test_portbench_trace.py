"""The trace reduction and the per-layer readers on a synthetic event list
(union, phases, op attribution, idle gaps), and the op names they match
in a real profile of a train step (the CPU's plain path)."""

from types import SimpleNamespace

import pytest
import torch

from portbench import cells, flops, trace
from portbench.run import MetricContext
from portbench.trace import DeviceOp, HostOp, Trace


def _synthetic() -> Trace:
    host = [
        HostOp("encode_image", 0.0, 2.0, -1, 0.0),                    # 0
        HostOp("aten::addmm", 0.1, 0.5, 0, 0.40),                     # 1
        HostOp("avion::flash_fwd_lse", 0.6, 0.9, 0, 0.25),            # 2
        HostOp("aten::empty", 0.61, 0.62, 2, 0.0),                    # 3
        HostOp("autograd::engine::evaluate_function: X", 3.0, 5.0, -1,
               0.0, thread=2),                                        # 4
        HostOp("aten::mm", 3.1, 3.5, 4, 0.80, thread=2),              # 5
        HostOp("avion::flash_bwd", 3.6, 4.5, 4, 0.50, thread=2),      # 6
        HostOp("aten::zero_", 3.7, 3.8, 6, 0.05, thread=2),           # 7
        HostOp("Optimizer.step#AdamW.step", 6.0, 7.0, -1, 0.0),       # 8
        HostOp("aten::_foreach_add_", 6.1, 6.5, 8, 0.20),             # 9
        HostOp("cudaStreamSynchronize", 7.5, 8.5, -1, 0.0),           # 10
    ]
    device = [DeviceOp("void gemm<1>(Params)", 0.2, 0.6),
              DeviceOp("flash_fwd_kernel<64>", 0.5, 0.75),
              DeviceOp("Memset (Device)", 3.2, 3.25),
              DeviceOp("gemm_bwd", 3.2, 4.0),
              DeviceOp("bwd_kv_kernel", 4.0, 4.55),
              DeviceOp("multi_tensor_apply_kernel", 6.2, 6.4),
              DeviceOp("multi_tensor_apply_kernel", 9.0, 9.1)]
    return Trace(host, device)


def test_union_counts_overlaps_once():
    t = _synthetic()
    # [0.2, 0.75] + [3.2, 4.55] + [6.2, 6.4] + [9.0, 9.1]
    assert trace.busy_s(t) == pytest.approx(0.55 + 1.35 + 0.2 + 0.1)
    assert trace.device_s(t) == pytest.approx(
        0.4 + 0.25 + 0.05 + 0.8 + 0.55 + 0.2 + 0.1)


def test_phases_and_ops_attribute_through_enclosing_ops():
    t = _synthetic()

    def under(prefix):
        return trace.device_s_under(t, lambda n: n.startswith(prefix))

    assert under("autograd::engine::evaluate_function") == pytest.approx(
        0.80 + 0.50 + 0.05)
    assert under("Optimizer.step#") == pytest.approx(0.20)
    names = {"avion::flash_fwd_lse", "avion::flash_bwd"}
    assert trace.device_s_under(t, lambda n: n in names) == pytest.approx(
        0.25 + 0.50 + 0.05)


def test_breakdown_names_kernels_and_idle_stretches():
    t = _synthetic()
    top = trace.top_device_ops(t)
    assert top[0] == ["gemm_bwd", pytest.approx(0.8)]
    assert ["multi_tensor_apply_kernel", pytest.approx(0.3)] in top
    gaps = dict((k, v) for k, v in trace.idle_gaps(t))
    # 0.75-3.2 (middle 1.975: encode_image), 4.55-6.2 (5.375: nothing),
    # 6.4-9.0 (7.7: the synchronize)
    assert gaps == {"encode_image": pytest.approx(2.45),
                    "(no host op)": pytest.approx(1.65),
                    "cudaStreamSynchronize": pytest.approx(2.6)}


def _context(t: Trace, metric: str) -> MetricContext:
    work = flops.StepWork(forward_flops=int(1e12), attention=[
        flops.AttentionLayers(32, 785, 12, 64, False, 12)])
    _, data = cells.metric_reader(metric)
    return MetricContext(trace=t, trace_steps=2, trace_wall_s=10.0,
                         window_steps=20, window_s=50.0, work=work,
                         data=data, config={}, traffic={})


def _read(metric: str, t: Trace):
    reader, _ = cells.metric_reader(metric)
    return reader.read(_context(t, metric))


def test_metric_readers_on_the_synthetic_trace():
    t = _synthetic()
    assert _read("optim.ms", t) == pytest.approx(1e3 * 0.20 / 2)
    assert _read("towers.bwd_ms", t) == pytest.approx(1e3 * 1.35 / 2)
    assert _read("towers.fwd_ms", t) == pytest.approx(
        1e3 * (2.35 - 1.35 - 0.20) / 2)
    assert _read("attn.ms", t) == pytest.approx(1e3 * 0.80 / 2)
    least = 12 * (0.0612511 + 0.1531279) * 1e-3
    assert _read("attn_roofline", t) == pytest.approx(
        100 * least * 2 / 0.80, rel=1e-5)
    # busy 2.2 s over 2 steps against 2.5 s a step in the window
    assert _read("device.idle", t) == pytest.approx(100 * (1 - 1.1 / 2.5))
    assert _read("step.mfu", t) == pytest.approx(
        100 * 3e12 * (20 / 50.0) / 989e12)


def test_readers_find_nothing_in_an_empty_trace():
    empty = Trace([], [])
    for metric in ("optim.ms", "towers.bwd_ms", "towers.fwd_ms", "attn.ms",
                   "attn_roofline", "device.idle"):
        assert _read(metric, empty) is None


def test_from_profile_keeps_parents_kernels_and_drops_mirrored_ranges():
    from torch.autograd import DeviceType

    def span(a, b):
        return SimpleNamespace(start=a, end=b)

    root = SimpleNamespace(name="outer", device_type=DeviceType.CPU,
                           time_range=span(0, 100), cpu_parent=None,
                           kernels=[], thread=1, is_async=False)
    child = SimpleNamespace(name="aten::mm", device_type=DeviceType.CPU,
                            time_range=span(10, 20), cpu_parent=root,
                            kernels=[SimpleNamespace(duration=30.0)],
                            thread=1, is_async=False)
    kernel = SimpleNamespace(name="gemm", device_type=DeviceType.CUDA,
                             time_range=span(15, 45),
                             is_user_annotation=False)
    mirror = SimpleNamespace(name="outer", device_type=DeviceType.CUDA,
                             time_range=span(0, 100),
                             is_user_annotation=True)
    prof = SimpleNamespace(events=lambda: [root, child, kernel, mirror])
    t = trace.from_profile(prof)
    assert [h.name for h in t.host] == ["outer", "aten::mm"]
    assert t.host[1].parent == 0 and t.host[0].parent == -1
    assert t.host[1].device_s == pytest.approx(30e-6)
    assert [(d.name, d.start, d.end) for d in t.device] == [
        ("gemm", 15e-6, 45e-6)]


def test_a_real_profile_names_what_the_readers_match(tiny_root):
    """The port's train step on the CPU under torch.profiler: the
    backward's, the optimizer's and the attention ops' names are there."""
    from portbench import run

    cell = cells.load("clip_tiny.pretrain", tiny_root)
    program, batches, _, _ = run.first_steps(cell, 3, torch.device("cpu"))
    t, wall = run.profile_steps(program, batches, 0, 1, torch.device("cpu"))
    names = {h.name for h in t.host}
    assert any(n.startswith("autograd::engine::evaluate_function")
               for n in names)
    assert any(n.startswith("Optimizer.step#AdamW.step") for n in names)
    _, data = cells.metric_reader("attn.ms")
    assert {"avion::flash_fwd_lse", "avion::flash_bwd"} <= names
    assert set(data["ops"]) >= {"avion::flash_fwd_lse", "avion::flash_bwd"}
    assert wall > 0
