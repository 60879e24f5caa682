"""The port's program spans (``core.profiling.span`` / ``backward_mark``) on
the CPU: one tiny train step a family under ``torch.profiler`` records
``avion.step`` with its phases in order, the tower spans inside the
forward and the towers' backward marks in the engine's order (which
``portbench/spans.py`` reads); without a profiler nothing is recorded and
no autograd node is added; and the profiler leaves the loss, the
gradients and the update bit for bit as they were."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from avion_tpu_torch.core import profiling
from avion_tpu_torch.core.config import OptimConfig
from avion_tpu_torch.core.train_state import TrainState
from avion_tpu_torch.models.registry import create_model
from avion_tpu_torch.optim.factory import build_optimizer
from avion_tpu_torch.train.steps import (make_clip_accum_train_step,
                                         make_clip_train_step,
                                         make_mir_finetune_step,
                                         make_videomae_train_step)

OPT = dict(lr=1e-3, lr_start=1e-4, warmup_epochs=0.5, epochs=1, wd=0.05,
           grad_clip_norm=1.0)
FAMILIES = ("clip", "accum", "mir", "videomae")
PHASES = ["avion.step.prep", "avion.step.forward", "avion.step.loss",
          "avion.step.backward", "avion.step.update"]
# each family's step phases, tower spans and backward marks in order
ORDER = {
    "clip": (PHASES, ["avion.tower.visual", "avion.tower.text"],
             ["avion.tower.text.bwd", "avion.tower.visual.bwd"]),
    "accum": (PHASES[:2] * 2 + PHASES[1:2] + (PHASES[:4] * 2) + PHASES[4:],
              ["avion.tower.visual", "avion.tower.text"] * 4,
              ["avion.tower.text.bwd", "avion.tower.visual.bwd"] * 2),
    "mir": (PHASES, ["avion.tower.visual", "avion.tower.text"],
            ["avion.tower.text.bwd", "avion.tower.visual.bwd"]),
    "videomae": (PHASES, ["avion.tower.encoder", "avion.tower.decoder"],
                 ["avion.tower.decoder.bwd", "avion.tower.encoder.bwd"]),
}


def _program(family):
    """(state, step, batch) of a tiny f32 model, the same on every call."""
    torch.manual_seed(0)
    g = torch.Generator().manual_seed(1)
    if family == "videomae":
        model = create_model("VIDEOMAE_TINY", dtype=torch.float32)
        model.init_weights(g)
        step = make_videomae_train_step(model, regen_mask=True)
        batch = {"video": torch.randint(0, 256, (4, 4, 32, 32, 3),
                                        generator=g, dtype=torch.uint8),
                 "mask": torch.zeros(4, model.num_patches, dtype=torch.bool)}
    else:
        model = create_model("CLIP_TINY", dtype=torch.float32)
        model.init_weights(g)
        rows = 4
        text = torch.randint(1, 49000, (rows, 77), generator=g)
        text[:, 9] = 49407
        batch = {"video": torch.randint(0, 256, (rows, 2, 32, 32, 3),
                                        generator=g, dtype=torch.uint8),
                 "text": text}
        if family == "accum":
            batch = {k: v.reshape(2, rows // 2, *v.shape[1:])
                     for k, v in batch.items()}
            step = make_clip_accum_train_step(model, 2)
        elif family == "mir":
            step = make_mir_finetune_step(model)
        else:
            step = make_clip_train_step(model)
    opt, _ = build_optimizer(OptimConfig(**OPT), model, 4)
    return TrainState.create(model, opt), step, batch


def _run(state, step, batch):
    """One step: (loss, gradients, parameters after the update)."""
    _, metrics = step(state, batch)
    params = state.model.named_parameters()
    return (metrics["loss"], {n: p.grad.clone() for n, p in params
                              if p.grad is not None},
            {n: p.detach().clone()
             for n, p in state.model.named_parameters()})


def _forward(state, step, batch):
    """The model's forward on ``batch`` (a valid tube mask for VideoMAE):
    a tower's output, with its autograd graph."""
    model = state.model
    if "mask" in batch:
        mask = torch.zeros_like(batch["mask"])
        mask[:, :model.num_patches - model.n_visible] = True
        return model(batch["video"].float(), mask)[0]
    return model(batch["video"].float(), batch["text"])["image_embed"]


@pytest.fixture(scope="module")
def runs():
    """Each family's step from the same start twice: without a profiler
    (with every ``record_function`` entered counted), and under one
    profiler for all of them, in ``FAMILIES``' order."""
    plain = {f: _program(f) for f in FAMILIES}
    traced = {f: _program(f) for f in FAMILIES}
    entered = []
    real = torch.ops.profiler._record_function_enter_new

    def enter(name, *args):
        entered.append(name)
        return real(name, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.ops.profiler, "_record_function_enter_new", enter)
        with profiling.span("avion.x"):
            x = torch.ones(2, requires_grad=True)
            assert profiling.backward_mark(x, "avion.x.bwd") is x
        out = {"plain": {f: _run(*plain[f]) for f in FAMILIES},
               "graphs": {f: _forward(*plain[f])
                          for f in ("clip", "videomae")},
               "entered": entered}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out["traced"] = {f: _run(*traced[f]) for f in FAMILIES}
    out["events"] = [e for e in prof.events() if e.name.startswith("avion.")]
    return out


def _names(events, parent=None):
    return [e.name for e in sorted(events, key=lambda e: e.time_range.start)
            if parent is None or (e.cpu_parent is not None
                                  and e.cpu_parent.name == parent)]


@pytest.mark.parametrize("family", FAMILIES)
def test_a_step_records_its_phases_towers_and_marks_in_order(runs, family):
    events = runs["events"]
    steps = sorted((e for e in events if e.name == "avion.step"),
                   key=lambda e: e.time_range.start)
    assert len(steps) == len(FAMILIES) and not any(e.cpu_parent
                                                   for e in steps)
    phases, towers, marks = ORDER[family]
    span = steps[FAMILIES.index(family)].time_range
    ours = [e for e in events
            if span.start <= e.time_range.start <= span.end]
    assert _names(ours, "avion.step") == phases
    assert _names(ours, "avion.step.update") == ["avion.step.read"]
    assert _names(ours, "avion.step.forward") == towers
    backward = [e.time_range for e in ours
                if e.name == "avion.step.backward"]
    got = [e for e in ours if e.name.endswith(".bwd")]
    assert _names(got) == marks
    for e in got:  # inside the engine's own op, inside a backward
        assert e.cpu_parent.name == "_BackwardMarkBackward"
        assert e.cpu_parent.cpu_parent.name.startswith(
            "autograd::engine::evaluate_function: _BackwardMarkBackward")
        assert any(b.start <= e.time_range.start <= b.end for b in backward)


@pytest.mark.parametrize("family", ["clip", "videomae"])
def test_without_a_profiler_nothing_is_recorded_and_no_node_added(runs,
                                                                  family):
    assert not [n for n in runs["entered"] if n.startswith("avion.")]
    seen, todo = set(), [runs["graphs"][family].grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        assert "BackwardMark" not in type(node).__name__
        todo.extend(n for n, _ in node.next_functions)
    assert len(seen) > 10


@pytest.mark.parametrize("family", FAMILIES)
def test_the_profiler_leaves_loss_gradients_and_update_bit_for_bit(runs,
                                                                   family):
    plain, got = runs["plain"][family], runs["traced"][family]
    assert torch.equal(plain[0], got[0])
    assert plain[1].keys() == got[1].keys() and plain[1]
    for part in (1, 2):
        for name in plain[part]:
            assert torch.equal(plain[part][name], got[part][name]), name
