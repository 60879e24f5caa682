"""The port's training blocks on the CPU: the remat policies give the
gradients of the plain stack and re-run the attention forward exactly
as the JAX policies do, patch dropout keeps the JAX token count, the
init draws the flax initializers' distributions, and the uint8 stem."""

import math

import numpy as np
import pytest
import torch

from avion_tpu_torch.models.layers import (Transformer, patch_dropout,
                                           saved_attn_layers)
from avion_tpu_torch.models.registry import create_model
from avion_tpu_torch.ops import flash_attention as fa

LAYERS = 3


def _grads(policy, causal, seed=0):
    torch.manual_seed(seed)
    net = Transformer(64, LAYERS, 2, dtype=torch.float32, causal=causal,
                      remat=policy is not None,
                      remat_policy=policy or "save_attn")
    x = torch.randn(2, 37, 64, requires_grad=True)
    fa.reset_launches()
    (net(x) ** 2).sum().backward()
    calls = fa.plain_calls["flash_fwd_lse"]
    return [x.grad] + [p.grad for p in net.parameters()], calls


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("policy,forwards", [
    ("save_attn", LAYERS), ("full", 2 * LAYERS),
    ("save_attn_k1", 1 + 2 * (LAYERS - 1))])
def test_remat_policies_match_and_count_forwards(policy, forwards, causal):
    ref, calls = _grads(None, causal)
    assert calls == LAYERS
    got, calls = _grads(policy, causal)
    assert calls == forwards
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-6)


def test_saved_attn_layers():
    assert saved_attn_layers("save_attn", 12) == 12
    assert saved_attn_layers("save_attn_k10", 12) == 10
    assert saved_attn_layers("full", 12) == 0
    with pytest.raises(ValueError):
        saved_attn_layers("save_everything", 12)


@pytest.mark.parametrize("s,prob", [(785, 0.5), (17, 0.9), (3, 0.99)])
def test_patch_dropout_keeps_cls_and_count(s, prob):
    x = torch.arange(2 * s, dtype=torch.float32).reshape(2, s, 1) \
        .expand(2, s, 4).contiguous()
    gen = torch.Generator().manual_seed(0)
    y = patch_dropout(x, prob, gen)
    n_keep = max(1, int((s - 1) * (1 - prob)))
    assert y.shape == (2, 1 + n_keep, 4)
    torch.testing.assert_close(y[:, 0], x[:, 0])
    for b in range(2):  # distinct non-CLS tokens of this row
        ids = y[b, 1:, 0].long().tolist()
        assert len(set(ids)) == n_keep
        assert all(b * s < i < (b + 1) * s for i in ids)
    assert torch.equal(patch_dropout(x, prob, torch.Generator().manual_seed(0)),
                       y)
    assert patch_dropout(x, 0.0, gen) is x


def test_patch_dropout_only_when_training():
    model = create_model("CLIP_TINY", patch_dropout=0.5)
    video = torch.randn(2, 2, 32, 32, 3)
    with torch.no_grad():
        a = model.encode_image(video)
        b = model.encode_image(video, deterministic=True)
        c = model.encode_image(video, deterministic=False,
                               generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b)
    assert not torch.allclose(a, c)


def test_init_weights_follow_flax_distributions():
    model = create_model("CLIP_TINY", temperature_init=0.05)
    model.init_weights(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    fc1 = sd["visual.transformer.resblocks.0.mlp.fc1.weight"]  # [256, 64]
    assert abs(fc1.std().item() - 64 ** -0.5) < 0.1 * 64 ** -0.5
    assert fc1.abs().max().item() <= 2 * 64 ** -0.5 / 0.87962566103423978
    assert torch.count_nonzero(
        sd["visual.transformer.resblocks.0.mlp.fc1.bias"]) == 0
    conv = sd["visual.conv1.weight"]  # fan in 3 * 16 * 16
    assert abs(conv.std().item() - 768 ** -0.5) < 0.1 * 768 ** -0.5
    assert torch.equal(sd["visual.ln_pre.weight"], torch.ones(64))
    assert torch.count_nonzero(sd["visual.temporal_embedding"]) == 0
    assert abs(sd["textual.positional_embedding"].std().item() - 0.01) < 2e-3
    assert abs(sd["textual.token_embedding.weight"].std().item()
               - 32 ** -0.5) < 0.05 * 32 ** -0.5
    assert math.isclose(sd["logit_scale"].item(), math.log(20.0),
                        rel_tol=1e-6)
    again = create_model("CLIP_TINY", temperature_init=0.05).init_weights(
        torch.Generator().manual_seed(0)).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_registry_refuses_later_slices():
    with pytest.raises(ValueError):
        create_model("CLIP_TINY", pooling="bogus")
    with pytest.raises(ValueError):
        create_model("CLIP_TINY", input_norm="bogus")


def test_input_norm_stem_matches_normalized_input():
    from avion_tpu_torch.data.transforms import normalize_video

    model = create_model("CLIP_TINY", input_norm="openai",
                         use_grad_checkpointing=True)
    raw = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (2, 2, 32, 32, 3), np.uint8))
    a = model.encode_image(raw)
    b = model.encode_image(normalize_video(raw, dtype=torch.float32))
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    a.sum().backward()
    assert model.visual.conv1.weight.grad is not None
