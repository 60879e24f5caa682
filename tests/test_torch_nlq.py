"""The port's EgoNLQ grounding (``avion_tpu_torch.egonlq``: ``nlq_eval``,
``nlq_dataset``, ``vslnet``, ``train_nlq``) against ``avion_tpu.egonlq`` on
the CPU, on the same weights (carried by ``params_from_jax``): the
metrics and the dataset's items exactly, VSLNet's forward (both variants,
masked) within 1e-5, its loss with a saturated sigmoid and the loss's
gradients within 5e-4, ``extract_top_spans`` exactly with ties, the
schedule against optax's, three AdamW steps of ``make_train_step``
against the JAX step at drop 0, the dropout's keep rate and scale, the
init's statistics against flax's, and ``train_nlq.main``'s first-epoch
preemption rule, its resume (bit for bit against an uninterrupted run) and
its refusal without CUDA.  The JAX side runs jitted."""

import functools
import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avion_tpu.egonlq import nlq_dataset as jds
from avion_tpu.egonlq import nlq_eval as jev
from avion_tpu.egonlq import train_nlq as jtrain
from avion_tpu.egonlq import vslnet as jv
from avion_tpu_torch.core.checkpoint import Checkpointer
from avion_tpu_torch.egonlq import nlq_dataset, nlq_eval, train_nlq, vslnet
from avion_tpu_torch.models.pt_import import params_from_jax
from avion_tpu_torch.parallel import launch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=5e-4, rtol=5e-4)
B, LV, LQ, DV, DQ = 3, 16, 5, 24, 12
KW = dict(dim=32, num_heads=4, max_pos_len=16)


def _inputs(seed=0):
    r = np.random.RandomState(seed)
    video = r.randn(B, LV, DV).astype(np.float32)
    query = r.randn(B, LQ, DQ).astype(np.float32)
    v_mask = np.ones((B, LV), np.float32)
    v_mask[0, 12:] = 0
    v_mask[2, 7:] = 0
    q_mask = np.ones((B, LQ), np.float32)
    q_mask[1, 3:] = 0
    return video, v_mask, query, q_mask


@functools.lru_cache()
def _params(use_cq_attention):
    jm = jv.VSLNet(**KW, use_cq_attention=use_cq_attention)
    return jax.jit(jm.init)(jax.random.PRNGKey(0), *_inputs())["params"]


def _pair(use_cq_attention=True, drop_rate=0.0):
    """(flax model, its params, the port's model on the same weights)."""
    jm = jv.VSLNet(**KW, drop_rate=drop_rate,
                   use_cq_attention=use_cq_attention)
    params = _params(use_cq_attention)
    pm = vslnet.VSLNet(DV, DQ, **KW, drop_rate=drop_rate,
                       use_cq_attention=use_cq_attention)
    pm.load_state_dict(params_from_jax(params), strict=True)
    return jm, params, pm


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# -- metrics and data ---------------------------------------------------------

def test_metrics_match_jax_on_random_predictions():
    r = np.random.RandomState(0)
    preds, gts = [], []
    for _ in range(40):
        s = r.uniform(0, 100, 5)
        preds.append(np.stack([s, s + r.uniform(0.5, 20, 5)], 1))
        g = r.uniform(0, 100)
        gts.append((g, g + r.uniform(1, 15)))
    for p, g in zip(preds, gts):
        np.testing.assert_array_equal(nlq_eval.temporal_iou(p, np.array(g)),
                                      jev.temporal_iou(p, np.array(g)))
    assert nlq_eval.evaluate_nlq(preds, gts) == jev.evaluate_nlq(preds, gts)
    got = nlq_eval.evaluate_nlq(preds, gts, thresholds=(0.1, 0.7),
                                topk=(1, 3))
    assert got == jev.evaluate_nlq(preds, gts, thresholds=(0.1, 0.7),
                                   topk=(1, 3))


@pytest.fixture(scope="module")
def feature_set(tmp_path_factory):
    """Planted-span features (40 rows, more than max_pos_len 32) and two
    more samples whose text is a token sequence [Lq, D] of lengths 3, 6."""
    root = str(tmp_path_factory.mktemp("nlq_feats"))
    ann = chip_smoke.write_nlq_features(root, 6, seed=1, lv=40, vdim=DV,
                                        qdim=DQ)
    r = np.random.RandomState(2)
    for i, lq in ((4, 3), (5, 6)):
        video = r.randn(24, DV).astype(np.float32)
        np.savez(osp.join(root, f"feat_{i}.npz"), video=video,
                 text=r.randn(lq, DQ).astype(np.float32))
    return root, ann


def test_dataset_items_and_collate_match_jax(feature_set):
    root, ann = feature_set
    samples = nlq_dataset.parse_nlq_annotations(ann)
    assert samples == jds.parse_nlq_annotations(ann)
    ours = nlq_dataset.NLQFeatureDataset(samples, root, 32)
    ref = jds.NLQFeatureDataset(samples, root, 32)
    for i in range(len(ours)):
        a, b = ours[i], ref[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
    got = train_nlq._collate([ours[i] for i in range(len(ours))])
    want = jtrain._collate([ref[i] for i in range(len(ref))])
    assert got["query"].shape == (6, 6, DQ)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for args in ((2.0, 4.0, 10.0, 10, 0.0), (3.3, 7.9, 64.0, 32, 0.1),
                 (0.0, 64.0, 64.0, 32, 0.2)):
        s, e, h = nlq_dataset.make_labels(*args)
        js, je, jh = jds.make_labels(*args)
        assert (s, e) == (js, je)
        np.testing.assert_array_equal(h, jh)


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("use_cq_attention", [True, False],
                         ids=["full", "small"])
def test_vslnet_forward_matches_jax(use_cq_attention):
    jm, params, pm = _pair(use_cq_attention, drop_rate=0.2)
    inputs = _inputs(3)
    want = jax.jit(jm.apply)({"params": params}, *inputs)
    with torch.no_grad():
        got = pm(*_t(*inputs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD_TOL)
    # masked rows get the mask value, their highlight exactly 0
    assert got[1][0, 13] < -1e29 and got[0][2, 9] == 0.0
    assert ("cq_attention.w4C" in pm.state_dict()) == use_cq_attention


def _batch(v_mask, seed=4):
    r = np.random.RandomState(seed)
    h = (r.rand(B, LV) < 0.3).astype(np.float32)
    return {"v_mask": v_mask, "h_labels": h,
            "start_label": np.array([2, 3, 0], np.int32),
            "end_label": np.array([4, 6, 5], np.int32)}


def test_loss_with_saturated_sigmoid_and_its_gradients():
    """Highlight logits of +-200 saturate the f32 sigmoid to exactly 1 and
    0 on labelled and unlabelled rows alike: the loss stays finite and the
    gradients with respect to every logit match JAX's."""
    _, v_mask, _, _ = _inputs()
    batch = _batch(v_mask)
    r = np.random.RandomState(5)
    h_logits = r.randn(B, LV).astype(np.float32)
    h_logits[:, :4] = 200.0
    h_logits[:, 4:8] = -200.0
    s_logits = 3 * r.randn(B, LV).astype(np.float32)
    e_logits = 3 * r.randn(B, LV).astype(np.float32)

    def jax_loss(h, s, e):
        score = jax.nn.sigmoid(jv.mask_logits(h, batch["v_mask"]))
        return jv.vslnet_loss(score, jv.mask_logits(s, batch["v_mask"]),
                              jv.mask_logits(e, batch["v_mask"]),
                              {k: jnp.asarray(v) for k, v in batch.items()})

    (want, want_aux), want_g = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(h_logits, s_logits,
                                                  e_logits)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    h, s, e = (x.requires_grad_() for x in _t(h_logits, s_logits, e_logits))
    score = torch.sigmoid(vslnet.mask_logits(h, tb["v_mask"]))
    assert (score[:, :4] == 1.0).all() and (score[:, 4:8] == 0.0).all()
    loss, aux = vslnet.vslnet_loss(
        score, vslnet.mask_logits(s, tb["v_mask"]),
        vslnet.mask_logits(e, tb["v_mask"]), tb)
    loss.backward()
    assert torch.isfinite(loss.detach())
    np.testing.assert_allclose(loss.item(), float(want), **FWD_TOL)
    for k in ("span_loss", "highlight_loss"):
        np.testing.assert_allclose(aux[k].item(), float(want_aux[k]),
                                   **FWD_TOL)
    for t, w in zip((h, s, e), want_g):
        assert torch.isfinite(t.grad).all()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("use_cq_attention", [True, False],
                         ids=["full", "small"])
def test_model_gradients_match_jax(use_cq_attention):
    jm, params, pm = _pair(use_cq_attention)
    inputs = _inputs(6)
    batch = _batch(inputs[1], seed=7)

    def jax_loss(p):
        out = jm.apply({"params": p}, *inputs)
        return jv.vslnet_loss(*out, {k: jnp.asarray(v)
                                     for k, v in batch.items()})[0]

    want = params_from_jax(jax.jit(jax.grad(jax_loss))(params))
    loss, _ = vslnet.vslnet_loss(*pm(*_t(*inputs)), dict(zip(
        batch, _t(*batch.values()))))
    loss.backward()
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_extract_top_spans_with_ties():
    r = np.random.RandomState(8)
    start = r.randn(4, 10).astype(np.float32)
    end = r.randn(4, 10).astype(np.float32)
    start[1] = 0.0  # uniform rows: every upper-triangle product ties
    end[1] = 0.0
    start[2, 5:] = end[2, 5:] = jv.MASK_VALUE  # masked: exact zeros
    start[3, :] = end[3, :] = jv.MASK_VALUE
    start[3, 0] = end[3, 0] = 0.0  # one visible row: one nonzero product
    for k in (1, 5, 20):
        want = jv.extract_top_spans(jnp.asarray(start), jnp.asarray(end), k)
        got = vslnet.extract_top_spans(*_t(start, end), k=k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # where 5 upper-triangle products are nonzero, the top 5 are spans
    si, ei = vslnet.extract_top_spans(*_t(start, end), k=5)
    assert (ei[:2] >= si[:2]).all()


# -- training -----------------------------------------------------------------

@pytest.mark.parametrize("total,proportion",
                         [(10, 0.0), (10, 0.3), (7, 0.5), (1, 0.0),
                          (64, 0.1)])
def test_schedule_matches_optax(total, proportion):
    begin = int(total * proportion)
    ours = train_nlq.linear_schedule(1e-3, 0.0, total, begin)
    ref = optax.linear_schedule(1e-3, 0.0, total, begin)
    for t in range(total + begin + 3):
        assert ours(t) == pytest.approx(float(ref(t)), rel=1e-6, abs=1e-12)


# the loss does not change when these shift every logit of one softmax
# (a key bias: a query's scores; fc2's bias: the start or end logits), so
# their gradient is rounding noise, which Adam turns into steps of +-lr
SHIFT_INVARIANT = ("attention_block.key.bias", "start_fc2.bias",
                   "end_fc2.bias")


def test_three_adamw_steps_match_jax():
    """The losses and, after 3 updates, every parameter within 1e-5 but
    SHIFT_INVARIANT's."""
    jm, params, pm = _pair(drop_rate=0.0)
    total, lr = 5, 1e-3
    schedule = optax.linear_schedule(lr, 0.0, total, int(total * 0.2))
    tx = optax.adamw(schedule, weight_decay=0.01)
    jstep = jtrain.make_train_step(jm, tx, 5.0)
    opt_state = tx.init(params)
    opt = train_nlq.build_optimizer(pm, lr)
    step = train_nlq.make_train_step(
        pm, opt, train_nlq.linear_schedule(lr, 0.0, total, int(total * 0.2)),
        5.0)
    for i in range(3):
        inputs = _inputs(10 + i)
        batch = {"video": inputs[0], "v_mask": inputs[1],
                 "query": inputs[2], "q_mask": inputs[3],
                 **_batch(inputs[1], seed=20 + i)}
        params, opt_state, jm_ = jstep(params, opt_state, batch,
                                       jax.random.PRNGKey(i))
        m = step({k: torch.from_numpy(v) for k, v in batch.items()}, i)
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]),
                                   **FWD_TOL)
    assert train_nlq._updates(opt) == 3
    want = params_from_jax(params)
    for name, p in pm.state_dict().items():
        if name.endswith(SHIFT_INVARIANT):
            continue
        np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                   err_msg=name, **FWD_TOL)


@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_dropout_keep_rate_and_scale(rate):
    x = torch.full((400, 500), 3.0)
    g = torch.Generator().manual_seed(0)
    y = vslnet.dropout(x, rate, False, g)
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept],
                                                        3.0 / (1 - rate)))
    again = vslnet.dropout(x, rate, False, torch.Generator().manual_seed(0))
    assert torch.equal(y, again)  # the mask is the generator's
    assert vslnet.dropout(x, rate, True, g) is x


def test_init_statistics_match_flax():
    """Each parameter's std and largest magnitude against flax's draw at
    the config's width 128 (within 25%: w4C, w4Q, w4mlu and pool_weight
    hold 128 values); constant leaves exactly."""
    dims = dict(dim=128, num_heads=8, max_pos_len=128)
    r = np.random.RandomState(0)
    video = r.randn(2, 128, 512).astype(np.float32)
    query = r.randn(2, 1, 512).astype(np.float32)
    masks = np.ones((2, 128), np.float32), np.ones((2, 1), np.float32)
    jm = jv.VSLNet(**dims)
    want = params_from_jax(jax.jit(jm.init)(jax.random.PRNGKey(1), video,
                                            masks[0], query,
                                            masks[1])["params"])
    pm = vslnet.VSLNet(512, 512, **dims).init_weights(
        torch.Generator().manual_seed(1))
    got = pm.state_dict()
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if (w == w.flatten()[0]).all():  # zeros or ones
            assert torch.equal(g, w), name
            continue
        for stat in (torch.std, lambda t: t.abs().max()):
            ratio = float(stat(g) / stat(w))
            assert 0.75 < ratio < 1.25, (name, ratio)


# -- the entry ----------------------------------------------------------------

def _entry_args(root, ann, out, *extra):
    return [f"annotations={ann}", f"feature_dir={root}",
            f"output_dir={out}", "epochs=2", "batch_size=8", "dim=16",
            "num_heads=2", "max_pos_len=32", "print_freq=1", *extra,
            "--device", "cpu"]


@pytest.fixture(scope="module")
def entry_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nlq_entry"))
    return root, chip_smoke.write_nlq_features(root, 16, seed=3, vdim=DV,
                                               qdim=DQ)


def test_first_epoch_preempt_saves_nothing(entry_set, tmp_path, monkeypatch):
    """SIGTERM before any epoch boundary must NOT checkpoint the
    mid-epoch state as a boundary; a later clean run checkpoints at its
    boundaries, and a third restores and trains nothing."""
    root, ann = entry_set
    out = str(tmp_path / "run")
    args = _entry_args(root, ann, out)
    monkeypatch.setattr(launch, "preempted", lambda: True)
    res = train_nlq.main(args)
    assert res["steps"] == 0
    assert Checkpointer(osp.join(out, "ckpt")).latest_step() is None

    monkeypatch.setattr(launch, "preempted", lambda: False)
    res = train_nlq.main(args)
    assert res["steps"] == 4
    assert Checkpointer(osp.join(out, "ckpt")).steps() == [2, 4]
    again = train_nlq.main(args)
    assert again["steps"] == 0 and again["step"] == 4
    assert Checkpointer(osp.join(out, "ckpt")).latest_step() == 4


def test_resume_after_preemption_is_exact(entry_set, tmp_path, monkeypatch):
    """Preempted in epoch 1 (the epoch-0 boundary is on disk), then
    resumed: the same dropout draws, data order and AdamW state as an
    uninterrupted run, so the same parameters bit for bit."""
    root, ann = entry_set
    ref = train_nlq.main(_entry_args(root, ann, str(tmp_path / "ref")))
    calls = []

    def preempt_in_epoch_1():
        calls.append(1)
        return len(calls) > 2  # steps 0 and 1 run, step 2 sees SIGTERM

    monkeypatch.setattr(launch, "preempted", preempt_in_epoch_1)
    out = str(tmp_path / "run")
    first = train_nlq.main(_entry_args(root, ann, out))
    assert first["steps"] == 2
    monkeypatch.setattr(launch, "preempted", lambda: False)
    second = train_nlq.main(_entry_args(root, ann, out))
    assert second["steps"] == 2 and second["step"] == 4
    want = ref["model"].state_dict()
    for k, v in second["model"].state_dict().items():
        assert torch.equal(v, want[k]), k


def test_evaluate_matches_jax(entry_set, tmp_path):
    root, ann = entry_set
    cfg = train_nlq.NLQConfig(annotations=ann, val_annotations=ann,
                              feature_dir=root, dim=16, num_heads=2,
                              max_pos_len=32, batch_size=8)
    jm = jv.VSLNet(dim=16, num_heads=2, max_pos_len=32)
    b0 = jtrain._collate([jds.NLQFeatureDataset(
        jds.parse_nlq_annotations(ann), root, 32)[0]])
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), b0["video"],
                              b0["v_mask"], b0["query"],
                              b0["q_mask"])["params"]
    pm = train_nlq.build_model(cfg, DV, DQ)
    pm.load_state_dict(params_from_jax(params))
    assert train_nlq.evaluate(cfg, pm) == jtrain.evaluate(cfg, jm, params)


def test_main_needs_cuda_unless_told_the_cpu(entry_set, tmp_path,
                                             monkeypatch):
    root, ann = entry_set
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "run")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_nlq.main(_entry_args(root, ann, out)[:-2])
    assert not osp.exists(out)
