"""The readers of the program's spans (``spans.py``) on a hand-built trace of
one step (its phases, two towers, their backward marks on the engine's
thread, a host read with its synchronization, a stray synchronization),
on traces that hold none of the program's spans, and in a traced run of
each tiny cell on an emulated card."""

import pytest
import torch

from portbench import cells, run, spans, trace
from portbench.run import MetricContext
from portbench.tests.conftest import TINY_CELLS
from portbench.tests.test_portbench_trace import _synthetic
from portbench.trace import DeviceOp, HostOp, Trace

NEW = ("step.syncs", "optim.update_ms", "towers.loss_ms",
       "device.idle_fwd_ms", "device.idle_bwd_ms", "device.idle_update_ms",
       "towers.visual_ms", "towers.text_ms", "towers.encoder_ms",
       "towers.decoder_ms")
OLD = ("optim.ms", "towers.fwd_ms", "towers.bwd_ms", "attn.ms",
       "device.idle")
EVAL = "autograd::engine::evaluate_function: "


def _step(marks: bool = True, stray: bool = True) -> Trace:
    """One CLIP-like step: the main thread 1 and the engine's thread 2;
    the marks' ops last, so that leaving them out moves no parent."""
    host = [
        HostOp("avion.step", 0.0, 10.0, -1, 0.0, 1),                   # 0
        HostOp("avion.step.prep", 0.0, 0.5, 0, 0.0, 1),                # 1
        HostOp("aten::to", 0.1, 0.4, 1, 0.05, 1),                      # 2
        HostOp("avion.step.forward", 0.5, 3.0, 0, 0.0, 1),             # 3
        HostOp("avion.tower.visual", 0.5, 2.0, 3, 0.0, 1),             # 4
        HostOp("aten::mm", 0.6, 1.0, 4, 0.5, 1),                       # 5
        HostOp("avion.tower.text", 2.0, 3.0, 3, 0.0, 1),               # 6
        HostOp("aten::mm", 2.1, 2.5, 6, 0.3, 1),                       # 7
        HostOp("avion.step.loss", 3.0, 3.5, 0, 0.0, 1),                # 8
        HostOp("aten::mm", 3.1, 3.3, 8, 0.1, 1),                       # 9
        HostOp("avion.step.backward", 3.5, 7.0, 0, 0.0, 1),            # 10
        HostOp(EVAL + "MmBackward0", 3.6, 3.8, -1, 0.0, 2),            # 11
        HostOp("aten::mm", 3.61, 3.7, 11, 0.05, 2),                    # 12
        HostOp(EVAL + "MmBackward0", 4.0, 4.5, -1, 0.0, 2),            # 13
        HostOp("aten::mm", 4.0, 4.4, 13, 0.6, 2),                      # 14
        HostOp(EVAL + "MmBackward0", 4.7, 6.5, -1, 0.0, 2),            # 15
        HostOp("aten::mm", 4.8, 6.0, 15, 1.0, 2),                      # 16
        HostOp("avion.step.update", 7.0, 10.0, 0, 0.0, 1),             # 17
        HostOp("aten::linalg_vector_norm", 7.1, 7.2, 17, 0.02, 1),     # 18
        HostOp("avion.step.read", 7.3, 8.0, 17, 0.0, 1),               # 19
        HostOp("aten::_local_scalar_dense", 7.31, 7.99, 19, 0.05, 1),  # 20
        HostOp("cudaMemcpyAsync", 7.32, 7.33, -1, 0.0, 1),             # 21
        HostOp("cudaStreamSynchronize", 7.34, 7.98, -1, 0.0, 1),       # 22
        HostOp("Optimizer.step#AdamW.step", 8.1, 9.5, 17, 0.0, 1),     # 23
        HostOp("aten::_foreach_add_", 8.2, 9.0, 23, 0.2, 1),           # 24
        HostOp("cudaStreamSynchronize", 10.5, 10.6, -1, 0.0, 1),       # 25
    ]
    if stray:
        host.append(HostOp("cudaDeviceSynchronize", 9.6, 9.7, -1, 0.0, 1))
    if marks:
        for t, name in ((3.9, "text"), (4.6, "visual")):
            n = len(host)
            host += [
                HostOp(EVAL + "_BackwardMarkBackward", t, t + 0.05, -1, 0.0,
                       2),
                HostOp("_BackwardMarkBackward", t + 0.01, t + 0.04, n, 0.0,
                       2),
                HostOp(f"avion.tower.{name}.bwd", t + 0.02, t + 0.02, n + 1,
                       0.0, 2)]
    device = [DeviceOp("k", a, b) for a, b in (
        (0.2, 0.25), (0.7, 1.2), (2.2, 2.5), (3.15, 3.25), (3.65, 3.7),
        (4.1, 4.7), (4.9, 5.9), (7.15, 7.17), (7.4, 7.45), (8.3, 8.5),
        (10.2, 10.3), (10.8, 10.9))]
    return Trace(host, device)


# the idle stretches' middles fall in: prep (0.25-0.7), forward (1.2-2.2,
# 2.5-3.15), loss (3.25-3.65); backward (3.7-4.1, 4.7-4.9, 5.9-7.15);
# update (7.17-7.4), read (7.45-8.3), update (8.5-10.2); none (10.3-10.8)
IDLE = {"fwd": 0.45 + 1.0 + 0.65 + 0.4, "bwd": 0.4 + 0.2 + 1.25,
        "update": 0.23 + 0.85 + 1.7, "between": 0.5}
BUSY = 0.05 + 0.5 + 0.3 + 0.1 + 0.05 + 0.6 + 1.0 + 0.02 + 0.05 + 0.2 + 0.1 \
    + 0.1


def _read(metric: str, t: Trace):
    reader, data = cells.metric_reader(metric)
    return reader.read(MetricContext(trace=t, trace_steps=1,
                                     trace_wall_s=12.0, window_steps=20,
                                     window_s=100.0, work=None, data=data,
                                     config={}, traffic={}))


def test_each_reader_gives_its_number_on_a_step():
    t = _step()
    assert _read("towers.loss_ms", t) == pytest.approx(100.0)
    assert _read("optim.update_ms", t) == pytest.approx(270.0)
    assert _read("optim.ms", t) == pytest.approx(200.0)
    # forward 0.5 + from the visual mark to the backward's end 1.0
    assert _read("towers.visual_ms", t) == pytest.approx(1500.0)
    # forward 0.3 + from the text mark to the visual mark 0.6
    assert _read("towers.text_ms", t) == pytest.approx(900.0)
    assert _read("towers.encoder_ms", t) is None
    # the read, and the stray synchronization; not the read's own
    # synchronization, nor one outside the step
    assert _read("step.syncs", t) == pytest.approx(2.0)
    assert _read("step.syncs", _step(stray=False)) == pytest.approx(1.0)


def test_a_synchronization_inside_a_read_is_not_counted_twice():
    t = _step(stray=False)
    reads, waits = ["aten::_local_scalar_dense"], ["cudaStreamSynchronize"]
    assert spans.syncs(t, reads, waits) == 1.0
    # the same synchronization outside the read counts once more
    lone = Trace([op if op.name != "aten::_local_scalar_dense"
                  else HostOp(op.name, 7.31, 7.335, op.parent, 0.05, 1)
                  for op in t.host], t.device)
    assert spans.syncs(lone, reads, waits) == 2.0
    # on another thread it is another wait
    other = Trace([op if op.start != 7.34
                   else HostOp(op.name, op.start, op.end, -1, 0.0, 2)
                   for op in t.host], t.device)
    assert spans.syncs(other, reads, waits) == 2.0


def test_idle_by_phase_scales_to_the_window_and_stays_within_it():
    t = _step()
    by = spans.idle_by_phase(t)
    assert by == pytest.approx(IDLE)
    assert trace.busy_s(t) == pytest.approx(BUSY)
    window_idle = 100.0 / 20 - BUSY  # seconds a step
    traced = sum(IDLE.values())
    got = {p: _read(f"device.idle_{p}_ms", t)
           for p in ("fwd", "bwd", "update")}
    for part, ms in got.items():
        assert ms == pytest.approx(1e3 * window_idle * IDLE[part] / traced)
    idle_ms = _read("device.idle", t) / 100 * 100.0 / 20 * 1e3
    assert idle_ms == pytest.approx(1e3 * window_idle)
    assert sum(got.values()) <= idle_ms
    assert sum(got.values()) == pytest.approx(
        idle_ms * (1 - IDLE["between"] / traced))


def test_the_marks_leave_the_other_readers_as_they_were():
    with_marks, without = _step(), _step(marks=False)
    for metric in OLD:
        assert _read(metric, with_marks) == _read(metric, without), metric
    assert _read("towers.bwd_ms", with_marks) == pytest.approx(1650.0)


@pytest.mark.parametrize("t", [_synthetic(), Trace([], []),
                               Trace(_step().host, [])],
                         ids=["no-spans", "empty", "no-card"])
def test_the_readers_find_nothing_without_spans_or_a_card(t):
    for metric in NEW:
        assert _read(metric, t) is None, metric


def _emulated(real):
    """``trace.from_profile`` with a card: every innermost ``aten::`` op
    launches a kernel that runs on the card while it runs on the host."""

    def from_profile(prof):
        t = real(prof)
        parents = {op.parent for op in t.host}
        device = []
        for i, op in enumerate(t.host):
            if i not in parents and op.name.startswith("aten::"):
                op.device_s = op.end - op.start
                device.append(DeviceOp(op.name, op.start, op.end))
        return Trace(t.host, device)

    return from_profile


@pytest.mark.parametrize("name", sorted(TINY_CELLS))
def test_a_traced_run_reports_every_new_entry_of_its_cell(tiny_root, name,
                                                          monkeypatch):
    monkeypatch.setattr(trace, "from_profile", _emulated(trace.from_profile))
    cell = cells.load(name, tiny_root)
    out = run.run_cell(cell, 2 ** 31 + 91, 0.2, True, torch.device("cpu"))
    assert out["correct"] is True
    suffix = "" if name == "clip_tiny.mir" else ".pretrain"
    names = {m["name"] for m in cell.per_layer}
    new = {q + suffix for q in NEW} & names
    towers = (("encoder", "decoder") if name.startswith("videomae")
              else ("visual", "text"))
    assert len(new) == 8 and {f"towers.{t}_ms{suffix}" for t in towers} \
        <= new
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(got) == names
    # the loss's read; on the CPU VideoMAE's mask check (``_assert_async``)
    # reads too, which the card checks on the device
    reads = 2.0 if name.startswith("videomae") else 1.0
    assert got["step.syncs" + suffix] == reads
    assert got["optim.update_ms" + suffix] >= got["optim.ms" + suffix]
    parts = sum(got[f"towers.{t}_ms{suffix}"] for t in towers) \
        + got["towers.loss_ms" + suffix] + got["optim.update_ms" + suffix]
    whole = sum(got[q + suffix] for q in ("towers.fwd_ms", "towers.bwd_ms",
                                          "optim.ms"))
    assert 0 < parts <= whole * 1.005
    idle = sum(got[f"device.idle_{p}_ms{suffix}"]
               for p in ("fwd", "bwd", "update"))
    # the phases' shares of the traced idle sum to at most one; on the CPU
    # the emulated card's traced busy time may exceed the window's step,
    # so the window's idle may be negative
    window = out["seconds"]["window"] / out["attempted"]
    window_idle = got["device.idle" + suffix] / 100 * window * 1e3
    assert abs(idle) <= abs(window_idle) * (1 + 1e-9) + 1e-9
