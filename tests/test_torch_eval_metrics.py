"""The port's zero-shot metrics (``avion_tpu_torch.eval.{retrieval,
classification}_metrics``) against the JAX package's, on seeded similarity,
relevancy, logit and label arrays with heavy ties: equal to 1e-12."""

import numpy as np
import pytest

from avion_tpu.eval import classification_metrics as jcm
from avion_tpu.eval import retrieval_metrics as jrm
from avion_tpu.eval.runners import _softmax as jax_softmax
from avion_tpu_torch.eval import classification_metrics as pcm
from avion_tpu_torch.eval import retrieval_metrics as prm
from avion_tpu_torch.eval.runners import _softmax

TOL = dict(rtol=0, atol=1e-12)


def _tied(rs, shape, levels):
    """Values on a grid of ``levels`` steps: many exact ties."""
    return rs.randint(0, levels, shape) / float(levels)


@pytest.mark.parametrize("seed,shape,levels", [
    (0, (12, 9), 4), (1, (30, 30), 3), (2, (7, 20), 11), (3, (25, 6), 2)])
def test_retrieval_metrics_match_jax(seed, shape, levels):
    rs = np.random.RandomState(seed)
    sim = _tied(rs, shape, levels)
    rel = rs.choice([0.0, 0.25, 0.5, 1.0], shape, p=[0.5, 0.2, 0.15, 0.15])
    rel[0] = 0.0  # a query with nothing relevant
    for name in ("get_map", "get_ndcg"):
        np.testing.assert_allclose(getattr(prm, name)(sim, rel),
                                   getattr(jrm, name)(sim, rel),
                                   err_msg=name, **TOL)
    np.testing.assert_array_equal(prm.k_count_mask(rel), jrm.k_count_mask(rel))
    kc = prm.k_count_mask(rel)
    np.testing.assert_array_equal(prm._dcg(sim, rel, kc),
                                  jrm._dcg(sim, rel, kc))


@pytest.mark.parametrize("seed", range(3))
def test_classification_metrics_match_jax(seed):
    rs = np.random.RandomState(seed)
    n, c = 40, 12
    logits = _tied(rs, (n, c), 5)
    labels = rs.randint(0, c, n)
    for k in ((1,), (1, 5), (3, 2)):
        np.testing.assert_allclose(pcm.topk_accuracy(logits, labels, k),
                                   jcm.topk_accuracy(logits, labels, k), **TOL)
    preds = np.argmax(logits, 1)
    cm = pcm.confusion_matrix(preds, labels, c)
    np.testing.assert_array_equal(cm, jcm.confusion_matrix(preds, labels, c))
    np.testing.assert_allclose(pcm.mean_class_accuracy(cm),
                               jcm.mean_class_accuracy(cm), **TOL)

    pairs = [(int(rs.randint(4)), int(rs.randint(6))) for _ in range(c)]
    probs = _softmax(logits)
    np.testing.assert_allclose(probs, jax_softmax(logits), **TOL)
    for mode in ("verb", "noun"):
        pi = pcm.get_marginal_indexes(pairs, mode)
        ji = jcm.get_marginal_indexes(pairs, mode)
        assert len(pi) == len(ji)
        for a, b in zip(pi, ji):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(pcm.marginalize(probs, pi),
                                   jcm.marginalize(probs, ji), **TOL)

    gt = (rs.rand(n, c) < 0.2).astype(np.float32)
    gt[:3] = 0.0  # rows without ground truth drop out
    gt[:, 0] = 0.0  # a class without positives is NaN
    for got, want in zip(pcm.charades_map(logits, gt),
                         jcm.charades_map(logits, gt)):
        np.testing.assert_allclose(got, want, **TOL)

    preds5 = _tied(rs, (n, 5), 3)
    answers = rs.randint(0, 5, n)
    types = rs.randint(1, 3, n)
    got = pcm.egomcq_accuracy(preds5, answers, types)
    want = jcm.egomcq_accuracy(preds5, answers, types)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    assert pcm.ZERO_SHOT_TEMPLATES == jcm.ZERO_SHOT_TEMPLATES
