"""The FLOP counts and attention bounds against numbers worked out by hand
for each cell, and against the bounds in the port's kernel table (PERF.md,
computed there by ``core.flops.attention_bound``)."""

import os

import pytest

from portbench import cells, flops

# forward FLOPs a step, by hand: patchify, 12 blocks of qkv + out + fc1 +
# fc2 (12 W^2 a token) and attention (4 B S^2 W), the projections, and
# the text tower's 12 blocks at S 77, W 512
HAND = {
    # B 256, S 785: 2*256*784*768*768 + 12*(2*256*785*768*9216
    # + 4*256*785^2*768) + 2*256*768*512 + 12*(2*256*77*512*6144
    # + 4*256*77^2*512) + 2*256*512*512
    "clip_vitb16.pretrain_4f_b256": 41714969477120,
    # B 64, S 3137, the same terms
    "clip_vitb16.mir_16f_b64": 57939829981184,
    # B 128: 160 visible and 1408 masked of 1568 tubes; patch_embed
    # 1536 -> 768 and 12 blocks on 160 tokens, 768 -> 384, 4 blocks of
    # W 384 on 1568 tokens, the head 384 -> 1536 on the 1408 masked
    "videomae_vitb16.pretrain_16f_b128": 8647379779584,
}


@pytest.mark.parametrize("workload", sorted(HAND))
def test_model_flops_match_the_hand_count(workload):
    cell = cells.load(workload)
    work = cell.family.step_work(cell.config, cell.traffic)
    assert work.forward_flops == HAND[workload]
    assert work.model_flops == 3 * HAND[workload]


def test_attention_layers_of_each_cell():
    def layers(workload):
        cell = cells.load(workload)
        return [(a.batch, a.seq, a.heads, a.head_dim, a.causal, a.layers)
                for a in cell.family.step_work(cell.config,
                                               cell.traffic).attention]

    assert layers("clip_vitb16.pretrain_4f_b256") == [
        (256, 785, 12, 64, False, 12), (256, 77, 8, 64, True, 12)]
    assert layers("clip_vitb16.mir_16f_b64") == [
        (64, 3137, 12, 64, False, 12), (64, 77, 8, 64, True, 12)]
    assert layers("videomae_vitb16.pretrain_16f_b128") == [
        (128, 160, 12, 64, False, 12), (128, 1568, 6, 64, False, 4)]


@pytest.mark.parametrize("shape,products,tensors,rows,ms,bound", [
    # PERF.md's kernel table: the forward and the combined backward at
    # ViT-B/16, 4 frames, batch 32; the causal text tower's forward
    ((32, 785, 12, 64, False), 2, 4, 1, 0.0612511, "operations"),
    ((32, 785, 12, 64, False), 5, 8, 1, 0.1531279, "operations"),
    ((64, 77, 8, 64, True), 2, 4, 1, 0.0060725, "bytes"),
    ((128, 1568, 6, 64, False), 2, 4, 1, 0.4887615, "operations"),
    # by hand: 8 tensors of 64*77*512*2 bytes and one row of 64*8*77*4
    # bytes at 3.35e12 bytes/s
    ((64, 77, 8, 64, True), 5, 8, 1,
     (8 * 64 * 77 * 512 * 2 + 64 * 8 * 77 * 4) / 3.35e12 * 1e3, "bytes"),
])
def test_attention_least_time(shape, products, tensors, rows, ms, bound):
    s, by = flops.attention_least_s(*shape, products=products,
                                    tensors=tensors, rows=rows)
    # the table gives 7 decimal places
    assert s * 1e3 == pytest.approx(ms, abs=5e-8)
    assert by == bound


def test_a_step_bounds_every_layer_forward_and_backward():
    a = flops.AttentionLayers(32, 785, 12, 64, False, 12)
    assert flops.attention_step_least_s([a]) * 1e3 == pytest.approx(
        12 * (0.0612511 + 0.1531279), abs=12 * 1e-7)
    # 4 frames at batch 256: 8 x the batch-32 bounds, and the text tower
    cell = cells.load("clip_vitb16.pretrain_4f_b256")
    work = cell.family.step_work(cell.config, cell.traffic)
    text = 12 * (4 + 8) * 256 * 77 * 512 * 2 + 12 * 2 * 256 * 8 * 77 * 4
    assert flops.attention_step_least_s(work.attention) * 1e3 == \
        pytest.approx(8 * 12 * (0.0612511 + 0.1531279)
                      + text / 3.35e12 * 1e3, abs=96 * 1e-7)


def test_peak_in_the_mfu_data_is_the_data_sheet_rate():
    _, data = cells.metric_reader("step.mfu")
    assert data["peak_flops"] == flops.PEAK_FLOPS == 989e12
    assert os.path.exists(os.path.join(cells.BENCH_DIR, "metrics",
                                       "step.mfu.py"))
