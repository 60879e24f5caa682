"""On the card, at each cell's own size: the sound program passes the
cell's limits and the control (the reference in float8 products in the
program's place) fails one of them.  Skips without a CUDA card; run it on
the card with ``python -m pytest -m cuda portbench/tests -q``."""

import pytest
import torch

from portbench import cells, compare, run

WORKLOADS = ["clip_vitb16.pretrain_4f_b256",
             "videomae_vitb16.pretrain_16f_b128", "clip_vitb16.mir_16f_b64"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_program_passes_and_the_control_fails(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run.fix_caches()
    device = torch.device("cuda", 0)
    cell = cells.load(workload)
    program, batches, readings, applied = run.first_steps(cell, 2 ** 32 + 9,
                                                          device)
    del program
    run.free(device)
    ref = run.reference_readings(cell, 2 ** 32 + 9, batches, device)
    control = run.reference_readings(cell, 2 ** 32 + 9, batches, device,
                                     "fp8")
    sound, fp8 = compare.gaps(readings, ref), compare.gaps(control, ref)
    assert applied
    assert compare.judge(sound, cell.limits)[0], sound
    assert not compare.judge(fp8, cell.limits)[0], fp8
