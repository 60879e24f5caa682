"""The harness end to end at a tiny size on the CPU, without the look for a
card: the result's format, ``correct`` true on the sound program and false
with the timed path broken underneath (a step that leaves the state
unchanged, half of each batch left out, a leaf left unmoved), the control
failing the limits, and the command's refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import cells, compare, nojax, run
from portbench.calibrate import half_batch
from portbench.tests.conftest import TINY_CELLS, TINY_LIMITS

CPU = torch.device("cpu")


def _run(tiny_root, name, traced=False, wrap_step=None):
    return run.run_cell(cells.load(name, tiny_root), 2 ** 31 + 77, 0.2,
                        traced, CPU, wrap_step=wrap_step)


@pytest.mark.parametrize("name", sorted(TINY_CELLS))
def test_a_sound_run_is_correct_and_well_formed(tiny_root, name):
    out = _run(tiny_root, name)
    assert out["correct"] is True
    assert list(out)[-1] == "checked"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["attempted"] >= 1 and out["failed"] == 0
    names = {m["name"] for m in cells.load(name, tiny_root).end_to_end}
    assert set(out["metrics"]) == names
    assert {n.split(".")[0] for n in names} == {"clips_per_s",
                                                  "peak_mem_gib", "setup_s"}
    assert all(v["value"] >= 0 for v in out["metrics"].values())
    for key, c in out["checked"].items():
        assert c["limit"] == TINY_LIMITS[key] and c["value"] < c["limit"]
    json.dumps(out)


def test_a_traced_run_reports_layers_and_the_window(tiny_root):
    out = _run(tiny_root, "clip_tiny.pretrain", traced=True)
    assert out["correct"] is True
    # the CPU has no device trace: only the step's share of the peak
    mfu = {m["name"] for m in cells.load("clip_tiny.pretrain",
                                         tiny_root).per_layer
           if m["name"].startswith("step.mfu")}
    assert len(mfu) == 1 and set(out["metrics"]) == mfu
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _unchanged(monkeypatch):
    from avion_tpu_torch.optim.factory import Optimizer

    monkeypatch.setattr(Optimizer, "update", lambda self, grad_norm=None:
                        None)


def _frozen_leaf(monkeypatch):
    from avion_tpu_torch.optim.factory import Optimizer

    real = Optimizer.update

    def update(self, grad_norm=None):
        self.params[0].grad = None
        return real(self, grad_norm)

    monkeypatch.setattr(Optimizer, "update", update)


@pytest.mark.parametrize("name", sorted(TINY_CELLS))
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "frozen_leaf"])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, name,
                                            fault):
    wrap = None
    if fault == "unchanged":
        _unchanged(monkeypatch)
    elif fault == "frozen_leaf":
        _frozen_leaf(monkeypatch)
    else:
        wrap = half_batch
    out = _run(tiny_root, name, wrap_step=wrap)
    assert out["correct"] is False
    failed = [k for k, c in out["checked"].items()
              if not c["value"] <= c["limit"]]
    assert failed
    if fault != "half_batch":
        assert out["checked"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", sorted(TINY_CELLS))
def test_the_control_fails_the_limits(tiny_root, name):
    """The reference in float8 products in the program's place reads far
    above the sound program and fails a limit."""
    cell = cells.load(name, tiny_root)
    program, batches, readings, _ = run.first_steps(cell, 41, CPU)
    del program
    ref = run.reference_readings(cell, 41, batches, CPU)
    control = run.reference_readings(cell, 41, batches, CPU, "fp8")
    sound, fp8 = compare.gaps(readings, ref), compare.gaps(control, ref)
    assert compare.judge(sound, cell.limits)[0]
    assert not compare.judge(fp8, cell.limits)[0]
    assert max(fp8[n] / max(sound[n], 1e-12) for n in compare.NAMES) > 30


def test_forbidden_modules_are_named_by_their_top_level_name():
    assert nojax.forbidden_loaded(["jax.numpy", "avion_tpu_torch.ops",
                                   "avion_tpu.ops", "flaxen", "os"]) == [
        "avion_tpu", "jax"]


def test_a_rehearsal_loads_nothing_of_jax(tiny_root):
    code = (
        "import torch\n"
        "from portbench import cells, nojax, run\n"
        f"cell = cells.load('clip_tiny.pretrain', {tiny_root!r})\n"
        "run.run_cell(cell, 1, 0.1, True, torch.device('cpu'))\n"
        "print(nojax.forbidden_loaded())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def _command(cwd, workload="clip_vitb16.pretrain_4f_b256"):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", "portbench.run",
                           "--workload", workload, "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=cwd,
                          capture_output=True, text=True, env=env,
                          timeout=600)


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here; the refusal is for machines "
                    "without one")
    res = _command(cells.ROOT)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "CUDA card" in res.stderr


def test_the_benchmark_alone_prints_no_result(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's folder
    (no program) fails."""
    shutil.copy(os.path.join(cells.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(cells.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    res = _command(str(tmp_path))
    assert res.returncode != 0
    assert res.stdout == ""
