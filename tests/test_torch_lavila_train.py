"""Training the LaViLa narrator through the port's narrator entry, on the
CPU at ``LAVILA_NARRATOR_TINY``'s widths in f32, with seeded weights from
the benchmark's plain reference (``portbench/reference/lavila.py``'s
``weight_spec``: the gates drawn open):

- ``make_narrator_step`` under LaViLa's freezing against the reference's
  ``follow`` over one and two steps: the losses, the trained leaves' first
  gradients and their changes; the frozen leaves bit for bit and outside
  the optimizer, and the frozen tower's forward without a graph;
- the divided attention's CUDA grouping (one flash sequence a frame or a
  grid position, the CLS query apart) run through the kernels' plain
  versions against the f32 path, forward and backward, in one call and
  split into calls of at most the kernels' batch;
- ``build_model_and_state`` and ``build_model`` with the LaViLa names
  (always frozen by LaViLa's recipe) and the VCLM's (never frozen), and
  ``main`` on decoded video with GPT-2's ids (a stand-in BPE: the
  vocabulary is not in the repository);
- the towers' and the divided attention's spans under a CPU profiler."""

import math

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from avion_tpu_torch.core.config import TrainConfig
from avion_tpu_torch.core.train_state import TrainState
from avion_tpu_torch.models import timesformer
from avion_tpu_torch.models.timesformer import DividedAttention
from avion_tpu_torch.ops import flash_attention as fa
from avion_tpu_torch.optim.factory import build_optimizer
from avion_tpu_torch.train import train_narrator
from portbench import cells, inputs, weights
from test_torch_narrator import ego4d  # noqa: F401  (a fixture)
from portbench.jobs import recipe_overrides
from portbench.reference import lavila
from portbench.reference.train import follow

CELL = "lavila_narrator_xl.caption_4f_b64"
XL = "VCLM_OPENAI_TIMESFORMER_LARGE_336PX_GPT2_XL"
TINY = dict(port_model="LAVILA_NARRATOR_TINY", image_size=32, patch_size=16,
            num_frames=2, vision_width=48, vision_layers=2, vision_heads=2,
            text_width=32, text_layers=3, text_heads=2, vocab_size=96,
            num_img_queries=8, pool_heads=2, pool_dim_head=16)
CPU = torch.device("cpu")
SEED = 2 ** 31 + 5


@pytest.fixture(scope="module")
def cell():
    real = cells.load(CELL)
    config = {**real.config, **TINY}
    traffic = {**real.traffic, "batch": 3,
               "video": {"frames": 2, "size": 32},
               "text": {"context": 9, "min_len": 2, "max_len": 6, "low": 1,
                        "high": 95, "sot": 95, "eot": 95},
               "reference": {"block": 2}}
    return config, traffic


def _cfg(traffic, *extra) -> TrainConfig:
    return TrainConfig().apply_overrides([
        "model.name=LAVILA_NARRATOR_TINY", "data.clip_length=2",
        "optim.fix_lr=true", *recipe_overrides(traffic["recipe"]), *extra])


def _program(config, traffic):
    """The entry's model (frozen by LaViLa's rule) with the reference's
    weights, its optimizer and step."""
    spec = lavila.weight_spec(config, traffic)
    cfg = _cfg(traffic)
    model = train_narrator.build_model(cfg).to_empty(device=CPU)
    model.load_state_dict(weights.make(spec, SEED, CPU), strict=True)
    optimizer, _ = build_optimizer(cfg.optim, model, 10,
                                   num_layers=model.layers)
    return (model, optimizer, TrainState.create(model, optimizer),
            train_narrator.make_narrator_step(model))


def test_frozen_steps_follow_the_reference(cell):
    config, traffic = cell
    model, optimizer, state, step = _program(config, traffic)
    spec = lavila.weight_spec(config, traffic)
    start = weights.make(spec, SEED, CPU)
    trained = {n for n, *_ in spec if lavila.trained(n)}
    assert set(optimizer.names) == trained
    assert {n for n, p in model.named_parameters()
            if p.requires_grad} == trained
    seen = []
    hook = model.visual.register_forward_hook(
        lambda m, i, o: seen.append(o.requires_grad or o.grad_fn is not None))
    batches = inputs.make(config, traffic, SEED, CPU)
    losses, grads = [], None
    for k in range(2):
        state, metrics = step(state, batches[k])
        assert metrics["step_ok"] == 1.0
        losses.append(float(metrics["loss"]))
        if k == 0:
            # the clipped gradient AdamW took, still on the leaves
            grads = {n: p.grad.clone() for n, p in model.named_parameters()
                     if p.grad is not None}
    hook.remove()
    assert seen == [False, False]  # the frozen tower records no graph
    ref = follow("lavila", config, traffic, start, batches, 2)
    # f32 on both sides; the port groups the divided attention where the
    # reference masks it, and sums the blocks' losses in another order
    assert losses == pytest.approx(ref["loss"], rel=1e-5)
    assert set(grads) == set(ref["grad_values"]) == trained
    for n, g in grads.items():
        r = ref["grad_values"][n]
        # a leaf's gradient to f32 rounding of its largest element
        torch.testing.assert_close(g, r, rtol=1e-4,
                                   atol=1e-5 * float(r.abs().max()) + 1e-12)
    lr = traffic["recipe"]["lr"]
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n not in trained:
                assert torch.equal(p, start[n]), n
                continue
            # Adam's first steps move an element by about lr whatever its
            # gradient's size: a hundredth of lr is f32 noise in g / |g|.
            # Left out: elements whose gradient is round-off (the key
            # third of the cross c_attn bias, which softmax makes nought),
            # which Adam moves by about lr either way
            r = ref["grad_values"][n].abs()
            keep = r >= 1e-3 * float(r.max())
            torch.testing.assert_close((p - start[n])[keep],
                                       ref["change"][n][keep],
                                       rtol=1e-3, atol=1e-2 * lr)


@pytest.mark.parametrize("mode", ["space", "time"])
def test_grouped_divided_attention_matches_the_f32_path(mode):
    torch.manual_seed(3)
    frames, n, width = 2, 4, 48
    attn = DividedAttention(width, 2, torch.float32)
    x = torch.randn(3, 1 + frames * n, width, requires_grad=True)
    qkv = F.linear(x, attn.qkv.weight, attn.qkv.bias)
    fa.reset_launches()
    got = attn.grouped(qkv, mode, frames, n)
    assert fa.plain_calls["flash_fwd_lse"] == 1  # one call a mode
    (gx,) = torch.autograd.grad(got.square().sum(), x, retain_graph=True)
    want = attn.plain(qkv, mode, frames, n)
    (wx,) = torch.autograd.grad(want.square().sum(), x)
    # the kernels' plain versions run the softmax in the log2 domain
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gx, wx, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        fa.reset_launches()
        torch.testing.assert_close(attn.grouped(qkv, mode, frames, n), want,
                                   rtol=1e-5, atol=1e-6)
        assert dict(fa.plain_calls) == {"flash_fwd": 1}


@pytest.mark.parametrize("mode", ["space", "time"])
def test_grouping_splits_past_the_kernels_batch(mode, monkeypatch):
    """Past the kernels' batch (5 here) the sequences go in several calls,
    forward and backward, to the f32 path's result."""
    monkeypatch.setattr(timesformer, "MAX_BATCH", 5)
    torch.manual_seed(4)
    frames, n, width = 2, 4, 48
    attn = DividedAttention(width, 2, torch.float32)
    qkv = torch.randn(3, 1 + frames * n, 3 * width, requires_grad=True)
    fa.reset_launches()
    got = attn.grouped(qkv, mode, frames, n)
    calls = math.ceil(3 * (frames if mode == "space" else n) / 5)
    assert dict(fa.plain_calls) == {"flash_fwd_lse": calls}
    (g,) = torch.autograd.grad(got.square().sum(), qkv)
    want = attn.plain(qkv, mode, frames, n)
    (w,) = torch.autograd.grad(want.square().sum(), qkv)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_the_entry_builds_the_frozen_narrator(cell):
    _, traffic = cell
    model, optimizer, _ = train_narrator.build_model_and_state(
        _cfg(traffic), 10, device="cpu")
    trained = [n for n, p in model.named_parameters() if p.requires_grad]
    assert sorted(optimizer.names) == sorted(trained)
    assert all(n.startswith(("img_", "text_decoder.")) for n in trained)
    assert len([n for n in trained if n.endswith("alpha_cattn")]) == 1
    # the published narrator, on the meta device: LaViLa's split
    xl = train_narrator.build_model(TrainConfig().apply_overrides(
        [f"model.name={XL}", "data.clip_length=4"]))
    count = sum(p.numel() for p in xl.parameters())
    held = sum(p.numel() for p in xl.parameters() if p.requires_grad)
    assert 2.45e9 < count < 2.46e9 and 4.9e8 < held < 4.95e8
    assert not any(p.requires_grad for p in xl.visual.parameters())
    # the VCLM trains every leaf, as before
    vclm = train_narrator.build_model(TrainConfig().apply_overrides(
        ["model.name=VCLM_VITB16", "data.clip_length=4"]))
    assert all(p.requires_grad for p in vclm.parameters())


class _Bpe:
    """GPT-2's tokenizer's interface over a made-up vocabulary of 96."""

    eos_token_id = 95

    def encode(self, text):
        return [1 + ord(c) % 94 for c in text]


def test_main_trains_on_gpt2_ids(ego4d, tmp_path, monkeypatch):  # noqa: F811
    from avion_tpu_torch.tools import narrator

    root, meta = ego4d
    monkeypatch.setattr(narrator, "gpt2_tokenizer", _Bpe)
    out = str(tmp_path / "run")
    res = train_narrator.main([
        "model.name=LAVILA_NARRATOR_TINY", f"data.root={root}",
        f"data.train_metadata={meta}", "data.clip_length=2",
        "data.crop_size=32", "data.batch_size=8", "data.num_workers=0",
        "optim.epochs=1", "optim.warmup_epochs=0", f"output_dir={out}",
        "--device", "cpu"])
    assert res["steps"] == res["step"] == 2
    assert math.isfinite(res["epochs"][0]["loss"])
    assert res["epochs"][0]["step_ok"] == 1.0
    # the captions as GPT-2's ids: one start-and-end id, padding 0
    _, loader = train_narrator.build_loader(
        _cfg({"recipe": cells.load(CELL).traffic["recipe"]},
             f"data.root={root}", f"data.train_metadata={meta}",
             "data.crop_size=32", "data.batch_size=8",
             "data.num_workers=0"), train_narrator.LAVILA_CONTEXT,
        tokenizer=train_narrator.BosEosIds(_Bpe()))
    text = next(iter(loader))["text"]
    loader.close()
    assert text.shape[1] == 77 and (text[:, 0] == 95).all()
    assert ((text == 95).sum(1) == 2).all()


def test_the_step_records_the_spans(cell):
    config, traffic = cell
    _, _, state, step = _program(config, traffic)
    batch = inputs.make(config, traffic, SEED, CPU)[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    names = [e.name for e in prof.events() if e.name.startswith("avion.")]
    blocks = config["vision_layers"]
    for name, count in (("avion.tower.visual", 1), ("avion.tower.pool", 1),
                        ("avion.tower.text", 1), ("avion.tower.pool.bwd", 1),
                        ("avion.tower.text.bwd", 1),
                        ("avion.attn.space", blocks),
                        ("avion.attn.time", blocks)):
        assert names.count(name) == count, (name, names)
    # the frozen tower has no backward to mark
    assert "avion.tower.visual.bwd" not in names
    assert math.isfinite(float(step(state, batch)[1]["loss"]))
