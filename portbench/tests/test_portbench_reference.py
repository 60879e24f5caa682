"""The plain reference against the port at a tiny width, on the same
weights and inputs (the port's f32 towers on the CPU), and the pieces the
reference shares with the benchmark: weights, inputs, the decay rule and
the learning rate."""

import pytest
import torch

from portbench import cells, inputs, weights
from portbench.reference import clip as ref_clip
from portbench.reference import videomae as ref_videomae
from portbench.reference.precision import matmul_for
from portbench.reference.train import decays, learning_rate

CPU = torch.device("cpu")


def _tiny(tiny_root, name):
    return cells.load(name, tiny_root)


def _port(cell, w):
    return cell.job.build(cell.config, cell.traffic, w, CPU)


def test_clip_towers_match_the_port(tiny_root):
    cell = _tiny(tiny_root, "clip_tiny.pretrain")
    w = weights.make(cell.family.weight_spec(cell.config, cell.traffic), 7,
                     CPU)
    model = _port(cell, w).model
    batch = inputs.make(cell.config, cell.traffic, 7, CPU)[0]
    mm = matmul_for("float32")
    with torch.no_grad():
        from avion_tpu_torch.train.steps import prep_video

        out = model(prep_video(batch["video"], dtype=torch.float32),
                    batch["text"].long())
        img = ref_clip.encode_video(cell.config, w, batch["video"], mm)
        txt = ref_clip.encode_text(cell.config, w, batch["text"], mm)
    torch.testing.assert_close(img, out["image_embed"], atol=2e-5, rtol=0)
    torch.testing.assert_close(txt, out["text_embed"], atol=2e-5, rtol=0)
    from avion_tpu_torch.losses.losses import (clip_loss,
                                               max_margin_ranking_loss)

    assert float(ref_clip.infonce(img, txt, w["logit_scale"])) == \
        pytest.approx(float(clip_loss(img, txt, out["logit_scale"])["loss"]),
                      rel=1e-6)
    assert float(ref_clip.max_margin(img, txt)) == pytest.approx(
        float(max_margin_ranking_loss(img, txt)["loss"]), rel=1e-6)


def test_videomae_matches_the_port(tiny_root):
    cell = _tiny(tiny_root, "videomae_tiny.pretrain")
    w = weights.make(cell.family.weight_spec(cell.config, cell.traffic), 7,
                     CPU)
    model = _port(cell, w).model
    batch = inputs.make(cell.config, cell.traffic, 7, CPU)[0]
    from avion_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
    from avion_tpu_torch.losses.losses import videomae_loss
    from avion_tpu_torch.train.steps import prep_video

    with torch.no_grad():
        video = prep_video(batch["video"], torch.float32, mean=IMAGENET_MEAN,
                           std=IMAGENET_STD)
        pred, idx = model(video, batch["mask"])
        port = videomae_loss(pred, video, idx, 16, 2)["loss"]
        total = ref_videomae.squared_error(
            cell.config, w, batch["video"], batch["mask"],
            matmul_for("float32"))
    count = pred.numel()
    assert float(total) / count == pytest.approx(float(port), rel=1e-5)


def test_sinusoid_table_matches_the_port():
    from avion_tpu_torch.models.videomae import sincos_pos_embed

    torch.testing.assert_close(ref_videomae.sincos_table(1568, 384),
                               torch.from_numpy(sincos_pos_embed(1568, 384)),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("workload", ["clip_vitb16.pretrain_4f_b256",
                                      "clip_vitb16.mir_16f_b64",
                                      "videomae_vitb16.pretrain_16f_b128"])
def test_weight_spec_is_the_port_layout_and_its_decay_rule(workload):
    """Every name and shape of the port's state dict at full width (built
    on the meta device), and the reference's decay rule picks the leaves
    the port's does."""
    from avion_tpu_torch.core.config import TrainConfig
    from avion_tpu_torch.optim.factory import wd_mask

    cell = cells.load(workload)
    spec = {n: tuple(s) for n, s, _, _ in
            cell.family.weight_spec(cell.config, cell.traffic)}
    entry = cell.traffic.get("entry", "videomae_pretrain")
    module = __import__(f"avion_tpu_torch.train.{entry}", fromlist=["x"])
    cfg = TrainConfig().apply_overrides([
        f"model.name={cell.config['port_model']}",
        f"data.clip_length={cell.traffic['video']['frames']}"])
    model = module.build_model(cfg)
    state = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    assert spec == state
    for n, p in model.named_parameters():
        assert decays(n, p) == wd_mask(n, p), n


def test_weights_and_inputs_come_from_the_seed_alone(tiny_root):
    cell = _tiny(tiny_root, "clip_tiny.pretrain")
    spec = cell.family.weight_spec(cell.config, cell.traffic)
    a, b = weights.make(spec, 2 ** 31 + 5, CPU), weights.make(
        spec, 2 ** 31 + 5, CPU)
    c = weights.make(spec, 6, CPU)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["image_projection"], c["image_projection"])
    assert float(a["logit_scale"]) == pytest.approx(float(
        torch.tensor(1 / 0.07).log()))
    x = inputs.make(cell.config, cell.traffic, 2 ** 33 + 1, CPU)
    y = inputs.make(cell.config, cell.traffic, 2 ** 33 + 1, CPU)
    z = inputs.make(cell.config, cell.traffic, 9, CPU)
    assert len(x) == cell.traffic["batches"]
    for bx, by, bz in zip(x, y, z):
        assert all(torch.equal(bx[k], by[k]) for k in bx)
        assert {k: v.shape for k, v in bx.items()} == \
            {k: v.shape for k, v in bz.items()}
        text = bx["text"]
        assert (text[:, 0] == 49406).all()
        eot = text.argmax(dim=-1)
        assert (text[torch.arange(text.shape[0]), eot] == 49407).all()
        length = eot - 1
        assert ((length >= 4) & (length <= 30)).all()
        assert ((text > 0).sum(dim=-1) == eot + 1).all()


def test_tube_masks_hide_the_same_count_in_every_row(tiny_root):
    cell = _tiny(tiny_root, "videomae_tiny.pretrain")
    for batch in inputs.make(cell.config, cell.traffic, 4, CPU):
        mask = batch["mask"]
        assert mask.shape == (8, 2 * 4)
        assert (mask.sum(dim=-1) == 2 * int(0.5 * 4)).all()
        assert torch.equal(mask[:, :4], mask[:, 4:])


def test_learning_rate_follows_the_port_schedule():
    from avion_tpu_torch.optim.schedules import cosine_schedule

    for name in ("pretrain_4f_b256", "pretrain_16f_b128", "mir_16f_b64"):
        r = cells.read_json(f"{cells.BENCH_DIR}/traffic/{name}.json")
        batch = r["batch"]
        base = r["recipe"]["lr"] * (batch / r["recipe"]["lr_scale_by_batch"]
                                    if r["recipe"].get("lr_scale_by_batch")
                                    else 1)
        port = cosine_schedule(base, r["recipe"]["lr_end"],
                               r["recipe"]["epochs"],
                               r["recipe"]["steps_per_epoch"],
                               r["recipe"]["warmup_epochs"],
                               r["recipe"]["lr_start"])
        for count in (0, 1, 2, 5000, 10 ** 7):
            assert learning_rate(r["recipe"], batch, count) == \
                pytest.approx(port(count), rel=1e-12)
