"""The LaViLa narrator's cell at a tiny size on the CPU: the port's
``LAVILA_NARRATOR_TINY`` through the narrator job, ``run.first_steps`` and
the comparison against the plain reference (``reference/lavila.py``), the
control and half a batch failing the limits, and the reference's weights,
FLOPs and least time at the cell's own size."""

import math
import os

import pytest
import torch

from portbench import cells, compare, run
from portbench.calibrate import half_batch
from portbench.reference import lavila
from portbench.tests.conftest import _write

CELL = "lavila_narrator_xl.caption_4f_b64"
TINY_CELL = "lavila_tiny.caption"
CPU = torch.device("cpu")
# f32 on both sides: the program's plain attention against the reference's
# masked one, and the blocks' sums in another order
LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3,
          "grad_gap_median": 1e-4, "change_gap_median": 1e-4}


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory) -> str:
    root = str(tmp_path_factory.mktemp("tiny_narrator"))
    real = cells.load(CELL)
    config = dict(real.config)
    config.update(port_model="LAVILA_NARRATOR_TINY", image_size=32,
                  patch_size=16, num_frames=2, vision_width=48,
                  vision_layers=2, vision_heads=2, text_width=32,
                  text_layers=3, text_heads=2, vocab_size=96,
                  num_img_queries=8, pool_heads=2, pool_dim_head=16)
    traffic = dict(real.traffic)
    traffic.update(batch=4, video={"frames": 2, "size": 32},
                   text={"context": 9, "min_len": 2, "max_len": 6, "low": 1,
                         "high": 95, "sot": 95, "eot": 95},
                   reference={"block": 3})
    _write(root, "portbench/configs/lavila_tiny.json", config)
    _write(root, "portbench/traffic/tiny_caption.json", traffic)
    _write(root, f"portbench/limits/{TINY_CELL}.json", LIMITS)
    bench = cells.read_json(os.path.join(cells.ROOT, "BENCHMARK.json"))
    bench["configs"] = [{"name": "lavila_tiny", "source": "test",
                         "file": "portbench/configs/lavila_tiny.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": TINY_CELL, "config": "lavila_tiny",
                           "traffic": "tiny_caption", "chips": 1,
                           "why": "test"}]
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if "workloads" in m:
                m["workloads"] = [TINY_CELL] if CELL in m["workloads"] else []
    _write(root, "BENCHMARK.json", bench)
    return root


def test_the_cell_is_correct_and_its_faults_are_not(tiny_root):
    cell = cells.load(TINY_CELL, tiny_root)
    seed = 2 ** 31 + 23
    _, batches, readings, applied = run.first_steps(cell, seed, CPU)
    assert applied and len(readings["loss"]) == 2
    ref = run.reference_readings(cell, seed, batches, CPU)
    # the optimizer holds the trained leaves only, the reference moves the
    # same ones
    trained = {n for n, *_ in cell.family.weight_spec(cell.config,
                                                      cell.traffic)
               if lavila.trained(n)}
    assert set(readings["grad"]) == set(ref["grad"]) == trained
    found = compare.gaps(readings, ref)
    ok, checked = compare.judge(found, cell.limits)
    assert ok, checked
    control = run.reference_readings(cell, seed, batches, CPU, "fp8")
    assert not compare.judge(compare.gaps(control, ref), cell.limits)[0]
    _, _, broken, _ = run.first_steps(cell, seed, CPU, wrap_step=half_batch)
    assert not compare.judge(compare.gaps(broken, ref), cell.limits)[0]


def test_a_run_reports_the_cells_metrics(tiny_root):
    out = run.run_cell(cells.load(TINY_CELL, tiny_root), 5, 0.2, True, CPU)
    assert out["correct"] is True
    # the CPU has no device trace: only the step's share of the peak
    assert set(out["metrics"]) == {"narrator.mfu"}


def test_the_weights_are_the_ports_and_the_sizes_the_widths_give():
    cell = cells.load(CELL)
    spec = lavila.weight_spec(cell.config, cell.traffic)
    from avion_tpu_torch.models.registry import create_model

    with torch.device("meta"):
        model = create_model(cell.config["port_model"], num_frames=4)
    shapes = {n: tuple(p.shape) for n, p in model.state_dict().items()}
    assert shapes == {n: tuple(s) for n, s, _, _ in spec}
    count = sum(math.prod(s) for _, s, _, _ in spec)
    trained = sum(math.prod(s) for n, s, _, _ in spec
                  if lavila.trained(n))
    assert 2.45e9 < count < 2.46e9 and 4.9e8 < trained < 4.95e8
    parts = lavila.step_flops(cell.config, cell.traffic)
    per_clip = {k: v / cell.traffic["batch"] / 1e12 for k, v in parts.items()}
    assert per_clip["visual_fwd"] == pytest.approx(1.99, abs=0.01)
    assert per_clip["text_fwd"] == pytest.approx(0.34, abs=0.01)
    assert per_clip["text_bwd"] == pytest.approx(0.45, abs=0.01)
    assert lavila.divided_attention_least_s(
        cell.config, cell.traffic) == pytest.approx(19.5e-3, rel=0.01)
