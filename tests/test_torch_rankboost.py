"""The port's RankBoost (``-ranker 2``) against the reference's on the
CPU.

* The pair potential π (closed form over label levels, midrange-shifted)
  against an f64 brute force over explicit (winner, loser) pairs, to 1e-6.
* The weak search's histogram at B = T + 1 (``ops.histogram``, its plain
  version here) against the reference's ``hist_xla`` on the same π, to
  1e-6.
* Whole fits: the (feature, threshold) sequence identical, alphas to
  rtol 1e-5, the same rollback under validation, silent or not.
* Model files load in both packages and score alike, also through
  ``convert.rankboost_from_reference``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ranklib_tpu.metrics.base import create_scorer as ref_create_scorer
from ranklib_tpu.models.base import load_ranker_file as ref_load
from ranklib_tpu.models.rankboost import RankBoost as RefRankBoost
from ranklib_tpu.models.rankboost import _bin_dtype
from ranklib_tpu.ops.histogram import hist_xla
from ranklib_tpu_torch.convert import rankboost_from_reference
from ranklib_tpu_torch.data.dataset import Dataset, Query, flatten
from ranklib_tpu_torch.metrics.base import create_scorer
from ranklib_tpu_torch.models import rankboost as PRB
from ranklib_tpu_torch.models.base import load_ranker_file as port_load
from ranklib_tpu_torch.utils.errors import RankLibError
from ranklib_tpu_torch.utils.logging import set_silent
from tests.fixtures import synth_dataset

CPU = torch.device("cpu")


def _port_ds(ds):
    return Dataset([Query(q.qid, q.labels.copy(), q.feats.copy(),
                          list(q.descs)) for q in ds.queries], ds.n_features)


@pytest.fixture(scope="module")
def data():
    return (synth_dataset(n_queries=30, n_features=8, seed=61, signal=2.0),
            synth_dataset(n_queries=10, n_features=8, seed=62, w_seed=61,
                          signal=2.0))


def _brute_pi(ds, H):
    """π(d) = Σ_y D(d, y) − Σ_x D(x, d) over explicit pairs, D ∝
    e^{−(H(x) − H(y))} for label(x) > label(y) within a query; f64."""
    _, labels, qptr = flatten(ds)
    pi = np.zeros(len(labels))
    Z = 0.0
    for q in range(len(qptr) - 1):
        s, e = qptr[q], qptr[q + 1]
        lab, h = labels[s:e], H[s:e].astype(np.float64)
        D = np.exp(-(h[:, None] - h[None, :])) * (lab[:, None] > lab[None, :])
        Z += D.sum()
        pi[s:e] = D.sum(axis=1) - D.sum(axis=0)
    return pi / Z


def test_pair_potential_and_weak_search_histogram(data):
    train, _ = data
    ds = _port_ds(train)
    _, _, rb_data, _ = PRB.RankBoost().prepare_fit(
        ds, create_scorer("NDCG@10"), None, CPU)
    N = rb_data.binned_T.shape[1]
    H = np.random.default_rng(5).normal(scale=2.0, size=N).astype(np.float32)
    scores = torch.from_numpy(np.append(H, 0.0).astype(np.float32))
    pot = PRB.pair_potential(scores, rb_data.tb, rb_data.uniq, N)
    np.testing.assert_allclose(pot.numpy(), _brute_pi(ds, H), rtol=0,
                               atol=1e-6)
    assert rb_data.binned_T.dtype == torch.int16
    hist, r_all = PRB.weak_search(rb_data.binned_T, pot, rb_data.ones, 10)
    want = np.asarray(hist_xla(jnp.asarray(rb_data.binned_T.numpy()),
                               jnp.asarray(pot.numpy()),
                               jnp.ones((N,), bool), 11)[..., 0])
    assert hist.shape == (8, 11)
    np.testing.assert_allclose(hist.numpy(), want, rtol=0, atol=1e-6)
    # r(f, t) = Σ_{b > t} hist[f, b]; the t = T column is all zero
    above = np.cumsum(want[:, ::-1], axis=1)[:, ::-1][:, 1:]
    np.testing.assert_allclose(r_all.numpy()[:, :-1], above, rtol=0,
                               atol=1e-6)
    assert not r_all[:, -1].any()


def _fit_both(train, vali, metric, silent=False, **hp):
    ref, port = RefRankBoost(**hp), PRB.RankBoost(**hp)
    ref.fit(train, ref_create_scorer(metric), vali)
    set_silent(silent)
    try:
        port.fit(_port_ds(train), create_scorer(metric),
                 _port_ds(vali) if vali is not None else None, device=CPU)
    finally:
        set_silent(False)
    return ref, port


def _assert_same_weaks(ref, port):
    assert len(port.weaks) == len(ref.weaks) > 0
    assert [w[:2] for w in port.weaks] == [w[:2] for w in ref.weaks]
    np.testing.assert_allclose([w[2] for w in port.weaks],
                               [w[2] for w in ref.weaks], rtol=1e-5)


@pytest.mark.parametrize("metric,tc,val,silent", [
    ("NDCG@10", 10, True, False), ("ERR@5", 4, False, True)],
    ids=["ndcg-validation", "err-tc4-silent"])
def test_fit_matches_the_reference(data, metric, tc, val, silent):
    train, vali = data
    ref, port = _fit_both(train, vali if val else None, metric, silent,
                          n_rounds=40, n_threshold=tc)
    _assert_same_weaks(ref, port)
    wt = port.fit_state.wt.numpy()
    assert wt.max() < tc                  # thresholds of the T-point grid


def test_models_load_across_packages_and_score_alike(data, tmp_path):
    train, vali = data
    ref = RefRankBoost(n_rounds=25)
    ref.fit(train, ref_create_scorer("NDCG@10"))
    want = np.concatenate(ref.eval_dataset(vali))
    ref.save(str(tmp_path / "ref.txt"))
    for port in (port_load(str(tmp_path / "ref.txt")),
                 rankboost_from_reference(ref)):
        assert isinstance(port, PRB.RankBoost)
        got = np.concatenate(port.eval_dataset(_port_ds(vali), CPU))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    port.save(str(tmp_path / "port.txt"))
    assert (open(tmp_path / "port.txt").read()
            == open(tmp_path / "ref.txt").read())
    assert ref_load(str(tmp_path / "port.txt")).weaks == ref.weaks


def test_bin_dtype_and_refusals():
    for T in (10, 32766, 32767, 40000):
        assert PRB.bin_dtype(T) == _bin_dtype(T)
    flat = Dataset([Query("1", np.ones(4, np.float32),
                          np.eye(4, dtype=np.float32))], 4)
    with pytest.raises(RankLibError, match="no correctly-ordered pairs"):
        PRB.RankBoost().fit(flat, create_scorer("NDCG@5"), device=CPU)
    with pytest.raises(RankLibError, match="not trained"):
        PRB.RankBoost().eval_dataset(flat, CPU)
