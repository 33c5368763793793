"""The port's Coordinate Ascent (``-ranker 4``, the CLI's default) and its
batched candidate evaluator against the reference's on the CPU.

* ``LinearMetricEvaluator``: mean and per-query metrics of random
  candidate matrices to 1e-6 (f32 products in another order than XLA's).
* The restarts' coordinate orders: the numpy draws the reference's sweep
  receives, exactly.
* Whole fits (restarts in lockstep, ``-reg``, validation): weights to
  1e-6 and the same printed pass and train-metric lines.
* Model files load in both packages and score alike, also through
  ``convert.coorascent_from_reference``.
"""

import numpy as np
import pytest
import torch

import ranklib_tpu.models.coorascent as RCA
from ranklib_tpu.metrics.base import create_scorer as ref_create_scorer
from ranklib_tpu.models.base import load_ranker_file as ref_load
from ranklib_tpu.ops.batched_eval import (
    LinearMetricEvaluator as RefEvaluator,
)
from ranklib_tpu_torch.convert import coorascent_from_reference
from ranklib_tpu_torch.data.dataset import Dataset, Query
from ranklib_tpu_torch.metrics.base import create_scorer
from ranklib_tpu_torch.models import coorascent as PCA
from ranklib_tpu_torch.models.base import load_ranker_file as port_load
from ranklib_tpu_torch.ops.batched_eval import LinearMetricEvaluator
from tests.fixtures import synth_dataset

CPU = torch.device("cpu")
HP = dict(n_restart=3, n_max_iteration=6, max_passes=3)


def _port_ds(ds):
    return Dataset([Query(q.qid, q.labels.copy(), q.feats.copy(),
                          list(q.descs)) for q in ds.queries], ds.n_features)


@pytest.fixture(scope="module")
def data():
    return (synth_dataset(n_queries=30, n_features=8, seed=51, signal=2.0),
            synth_dataset(n_queries=10, n_features=8, seed=52, w_seed=51,
                          signal=2.0))


@pytest.mark.parametrize("metric", ["NDCG@10", "MAP"])
def test_evaluator_matches_the_reference(data, metric):
    train, _ = data
    W = np.random.default_rng(3).normal(size=(8, 12)).astype(np.float32)
    W[:, 0] = 0.0                                  # all-tied candidate
    ref = RefEvaluator(train, ref_create_scorer(metric))
    port = LinearMetricEvaluator(_port_ds(train), create_scorer(metric), CPU)
    np.testing.assert_allclose(port.mean_metric(W), ref.mean_metric(W),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.per_query_matrix(W),
                               ref.per_query_matrix(W), rtol=0, atol=1e-6)


def _capture_orders(monkeypatch, module, seen):
    """Wrap ``module.make_sweep`` so each sweep records its order_T."""
    orig = module.make_sweep

    def make(*args, **kw):
        sweep = orig(*args, **kw)

        def recorded(w, cur, order_T, buckets):
            seen.append(np.asarray(order_T))
            return sweep(w, cur, order_T, buckets)

        return recorded

    monkeypatch.setattr(module, "make_sweep", make)


def test_restart_orders_match_the_reference(data, monkeypatch):
    train, _ = data
    got = {"ref": [], "port": []}
    _capture_orders(monkeypatch, RCA, got["ref"])
    _capture_orders(monkeypatch, PCA, got["port"])
    hp = dict(n_restart=4, n_max_iteration=2, max_passes=1, seed=9)
    RCA.CoorAscent(**hp).fit(train, ref_create_scorer("NDCG@5"))
    PCA.CoorAscent(**hp).fit(_port_ds(train), create_scorer("NDCG@5"),
                             device=CPU)
    assert got["ref"][0].shape == (8, 4)
    np.testing.assert_array_equal(got["port"][0], got["ref"][0])
    np.testing.assert_array_equal(PCA.restart_orders(8, 4, 9), got["ref"][0])


def _lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith("  pass ") or " data:" in ln]


@pytest.mark.parametrize("metric,reg,val", [
    ("NDCG@10", None, True), ("ERR@5", 0.01, False)],
    ids=["ndcg-validation", "err-reg"])
def test_fit_matches_the_reference(data, capsys, metric, reg, val):
    train, vali = data
    ref = RCA.CoorAscent(reg=reg, **HP)
    ref.fit(train, ref_create_scorer(metric), vali if val else None)
    ref_out = capsys.readouterr().out
    port = PCA.CoorAscent(reg=reg, **HP)
    port.fit(_port_ds(train), create_scorer(metric),
             _port_ds(vali) if val else None, device=CPU)
    port_out = capsys.readouterr().out
    np.testing.assert_allclose(port.weights, ref.weights, rtol=0, atol=1e-6)
    assert abs(np.abs(port.weights).sum() - 1.0) < 1e-12
    assert _lines(port_out) == _lines(ref_out)
    assert any("on training data" in ln for ln in _lines(port_out))
    assert any("on validation data" in ln
               for ln in _lines(port_out)) == val


def test_models_load_across_packages_and_score_alike(data, tmp_path):
    train, vali = data
    ref = RCA.CoorAscent(n_restart=1, n_max_iteration=4, max_passes=2)
    ref.fit(train, ref_create_scorer("NDCG@10"))
    want = np.concatenate(ref.eval_dataset(vali))
    ref.save(str(tmp_path / "ref.txt"))
    for port in (port_load(str(tmp_path / "ref.txt")),
                 coorascent_from_reference(ref)):
        assert isinstance(port, PCA.CoorAscent)
        got = np.concatenate(port.eval_dataset(_port_ds(vali), CPU))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    port.save(str(tmp_path / "port.txt"))
    assert (open(tmp_path / "port.txt").read()
            == open(tmp_path / "ref.txt").read())
    np.testing.assert_array_equal(
        ref_load(str(tmp_path / "port.txt")).weights, ref.weights)
