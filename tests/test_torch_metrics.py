"""The port's evaluation metrics (biomedkg_tpu_torch/training/metrics.py)
against the JAX package's on the same arrays: ``binary_auroc``,
``binary_average_precision``, ``binary_f1``, ``BootstrappedBinaryMetrics``
(with and without the subsampled bootstrap), ``HistogramBinaryMetrics``
(host updates, ``merge_state``, logits and probabilities, the latter
through ``_prob_mode``) and ``EdgeWisePrecision`` (the raw-score 0.5
threshold, hazard H5).

Tolerance: bit-equal. Both sides are the same numpy arithmetic."""

import numpy as np
import pytest

from biomedkg_tpu.training import metrics as jax_metrics
from biomedkg_tpu_torch.training import metrics


def _data(seed, n=3000, ties=False, probs=False):
    rng = np.random.default_rng(seed)
    target = (rng.random(n) < 0.3).astype(np.float64)
    preds = rng.standard_normal(n) + 1.5 * target
    if ties:
        preds = np.round(preds, 1)
    if probs:
        preds = 1.0 / (1.0 + np.exp(-preds))
    weights = rng.poisson(1.0, n).astype(np.float64)
    return preds, target, weights


CASES = [dict(), dict(ties=True), dict(probs=True), dict(n=0)]


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("fn", ["binary_auroc", "binary_average_precision",
                                "binary_f1"])
def test_binary_functions_equal_jax(fn, case):
    preds, target, weights = _data(case, **CASES[case])
    for w in (None, weights):
        assert getattr(metrics, fn)(preds, target, w) == \
            getattr(jax_metrics, fn)(preds, target, w)


@pytest.mark.parametrize("subsample", [False, True])
@pytest.mark.parametrize("case", range(3))
def test_bootstrapped_metrics_equal_jax(case, subsample, monkeypatch):
    """Point values, bootstrap means and stds; ``subsample`` runs the
    MAX_BOOTSTRAP_N path (a subsample, the std rescaled)."""
    if subsample:
        for m in (metrics, jax_metrics):
            monkeypatch.setattr(m.BootstrappedBinaryMetrics,
                                "MAX_BOOTSTRAP_N", 1000)
    out = []
    for m in (metrics, jax_metrics):
        b = m.BootstrappedBinaryMetrics(prefix="val_", seed=case)
        for chunk in np.array_split(np.arange(3000), 3):
            preds, target, _ = _data(case, **CASES[case])
            b.update(preds[chunk], target[chunk])
        out.append(b.compute())
    assert out[0] == out[1]
    assert len(out[0]) == 9
    fresh = metrics.BootstrappedBinaryMetrics()
    assert fresh.compute() == {}


@pytest.mark.parametrize("case", range(3))
def test_histogram_metrics_equal_jax(case):
    """Host updates with and without weights, a merged device-style
    state, and ``_prob_mode`` (scores all in [0, 1])."""
    preds, target, weights = _data(case, **CASES[case])
    hist = np.random.default_rng(case).poisson(3.0, (2, 32768))
    counts = np.array([5.0, 7.0, 11.0])
    out = []
    for m in (metrics, jax_metrics):
        h = m.HistogramBinaryMetrics(prefix="test_", seed=case)
        h.update(preds, target)
        h.update(preds[:500], target[:500], weights[:500])
        first = (h.compute(), h._prob_mode())
        h.merge_state(hist, counts)
        out.append((first, h.compute(), h.hist.copy(), h.f1_counts.copy()))
    (a_first, a, a_hist, a_f1), (b_first, b, b_hist, b_f1) = out
    assert a_first == b_first and a == b
    assert np.array_equal(a_hist, b_hist) and np.array_equal(a_f1, b_f1)
    assert a_first[1] == bool(CASES[case].get("probs"))
    assert metrics.HistogramBinaryMetrics().compute() == {}


def test_edgewise_precision_equal_jax():
    """Per-relation share of positives whose raw score is above 0.5, a
    mask, ids outside the mapping dropped; a relation with no edge reads
    0."""
    rng = np.random.default_rng(5)
    mapping = {0: "drug_drug", 1: "indication", 2: "off-label use",
               3: "never_seen"}
    preds = rng.standard_normal(400)
    target = rng.integers(-1, 3, 400)
    mask = rng.random(400) < 0.8
    out = []
    for m in (metrics, jax_metrics):
        e = m.EdgeWisePrecision(class_mapping=mapping)
        e.update(preds, target, mask=mask)
        e.update(preds[:50] - 10.0, target[:50])
        out.append(e.compute())
    assert out[0] == out[1]
    assert set(out[0]) == {f"{v}_pre" for v in mapping.values()}
    assert out[0]["never_seen_pre"] == 0.0


def test_transe_scores_give_f1_zero():
    """Hazard H5: TransE's raw scores are negative distances, so
    sigmoid(score) < 0.5 everywhere: no prediction is positive and F1 is
    exactly 0 on both paths, as in the reference."""
    rng = np.random.default_rng(7)
    preds = -np.abs(rng.standard_normal(2000)) - 1e-3
    target = (rng.random(2000) < 0.5).astype(np.float64)
    for m in (metrics, jax_metrics):
        b = m.BootstrappedBinaryMetrics(prefix="test_")
        b.update(preds, target)
        h = m.HistogramBinaryMetrics(prefix="test_")
        h.update(preds, target)
        assert b.compute()["test_F1"] == 0.0
        assert h.compute()["test_F1"] == 0.0
