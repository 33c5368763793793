"""The port's fused lambda route (ranklib_tpu_torch.ops.lambda_kernel)
against the reference's Pallas kernel.

The same numpy-seeded chunks go through the reference's
``lambda_weights_fused`` in interpret mode (as tests/test_lambda_kernel.py
runs it on the CPU) and the port's ``lambda_weights_fused``, whose pair
step is the plain version on a CPU tensor. Tolerance atol 2e-5, rtol 1e-4,
the one tests/test_lambda_kernel.py:38-41 holds the reference's kernel to
(f32 pair sums in another order), at every D. The CUDA kernel runs only
on a card; chip_smoke.py holds it to the plain version there. Here a
Python emulation of its per-position loop pins the winner/loser split.
Then the routing: the opt-in flag, the metrics it leaves alone, the sorted
path the fused route must agree with, and a whole fit under the flag.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ranklib_tpu.metrics.base import create_scorer as ref_create_scorer
from ranklib_tpu.ops import lambda_kernel as RK
from ranklib_tpu_torch.gbdt import boost as PBoost
from ranklib_tpu_torch.gbdt import lambdas as PL
from ranklib_tpu_torch.metrics.base import create_scorer
from ranklib_tpu_torch.models.gbdt import LambdaMART
from ranklib_tpu_torch.ops import lambda_kernel as LK
from ranklib_tpu_torch.utils.errors import RankLibError
from tests.fixtures import synth_dataset

CPU = torch.device("cpu")
TOL = dict(atol=2e-5, rtol=1e-4)
FLAG = "RANKLIB_TPU_FUSED_LAMBDA"


def _case(B, D, seed, gmax=2):
    """tests/test_lambda_kernel.py's draws: labels 0..gmax, N(0,1) scores,
    2..D valid docs a row, padded labels 0."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, gmax + 1, size=(B, D)).astype(np.float32)
    scores = rng.normal(size=(B, D)).astype(np.float32)
    n = rng.integers(2, D + 1, size=B)
    mask = np.arange(D)[None, :] < n[:, None]
    labels[~mask] = 0.0
    return labels, scores, mask


@pytest.mark.parametrize("metric", ["NDCG@10", "NDCG@3", "DCG@5", "P@4",
                                    "P@0"])
@pytest.mark.parametrize("B,D", [(4, 8), (3, 16), (2, 512), (2, 640),
                                 (2, 1024)])
def test_fused_route_matches_reference_kernel(metric, B, D):
    chunk = _case(B, D, seed=B * D + len(metric))
    want = RK.lambda_weights_fused(ref_create_scorer(metric),
                                   *map(jnp.asarray, chunk), interpret=True)
    got = LK.lambda_weights_fused(create_scorer(metric),
                                  *map(torch.from_numpy, chunk))
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    mask = chunk[2]
    assert not got[0].numpy()[~mask].any() and not got[1].numpy()[~mask].any()


@pytest.mark.parametrize("metric", ["NDCG@10", "NDCG@3", "DCG@5", "P@4",
                                    "P@0", "ERR@10", "MAP"])
def test_separable_vectors_match_reference(metric):
    labels, scores, mask = _case(5, 24, seed=len(metric))
    order = np.argsort(np.where(mask, -scores, np.inf), axis=1, kind="stable")
    L = np.take_along_axis(labels, order, 1)
    n = mask.sum(1).astype(np.int32)
    want = RK.separable_vectors(ref_create_scorer(metric), jnp.asarray(L),
                                jnp.asarray(n))
    got = LK.separable_vectors(create_scorer(metric), torch.from_numpy(L),
                               torch.from_numpy(n))
    if want is None:
        assert got is None
        return
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)


def _emulate_kernel(A, Bv, L, S, V):
    """What csrc/lambda_pairs.cu computes, position by position in float64:
    winner and loser sums kept apart, q in order, lam = winner − loser."""
    lam = np.zeros(A.shape)
    w = np.zeros(A.shape)
    for r in range(A.shape[0]):
        for p in range(A.shape[1]):
            if V[r, p] == 0:
                continue
            wl = ll = ww = lw = 0.0
            for q in range(A.shape[1]):
                if L[r, q] == L[r, p]:
                    continue
                vv = V[r, p] * V[r, q]
                delta = abs(A[r, p] - A[r, q]) * abs(Bv[r, p] - Bv[r, q])
                winner = L[r, p] > L[r, q]
                x = S[r, q] - S[r, p] if winner else S[r, p] - S[r, q]
                rho = 1.0 / (1.0 + np.exp(-x))
                if winner:
                    wl += vv * rho * delta
                    ww += vv * rho * (1.0 - rho) * delta
                else:
                    ll += vv * rho * delta
                    lw += vv * rho * (1.0 - rho) * delta
            lam[r, p], w[r, p] = wl - ll, ww + lw
    return lam, w


def test_kernel_loop_equals_plain_pair_block():
    labels, scores, mask = _case(3, 20, seed=4)
    scores[0, :6] = 0.5                            # score ties
    L = torch.from_numpy(labels)
    n = torch.from_numpy(mask.sum(1).astype(np.int32))
    A, Bv = LK.separable_vectors(create_scorer("NDCG@5"), L, n)
    args = (A, Bv, L, torch.from_numpy(scores),
            torch.from_numpy(mask.astype(np.float32)))
    plain = LK.lambda_pairs_plain(*args)
    emu = _emulate_kernel(*(a.double().numpy() for a in args))
    for g, w in zip(plain, emu):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=1e-5)


def test_wrapper_checks_inputs_and_counts_only_kernel_launches():
    labels, scores, mask = _case(2, 8, seed=1)
    t = [torch.from_numpy(a) for a in (labels, labels, labels, scores,
                                       mask.astype(np.float32))]
    before = LK.lambda_pairs.launches
    LK.lambda_pairs(*t)
    assert LK.lambda_pairs.launches == before          # CPU: plain version
    bad = [
        lambda: LK.lambda_pairs(t[0].double(), *t[1:]),
        lambda: LK.lambda_pairs(t[0][:, :4], *t[1:]),
        lambda: LK.lambda_pairs(t[0].T.contiguous().T, *t[1:]),
        # neither CPU nor CUDA: raises, never falls back to the plain path
        lambda: LK.lambda_pairs(*(x.to("meta") for x in t)),
    ]
    for call in bad:
        with pytest.raises(RankLibError):
            call()


def _which(monkeypatch, metric, flag):
    """The name of the path ``lambda_fn`` routes one chunk to."""
    if flag:
        monkeypatch.setenv(FLAG, "1")
    else:
        monkeypatch.delenv(FLAG, raising=False)
    for name in ("lambda_weights_fused", "lambda_weights_nosort",
                 "lambda_weights_nosort_err", "lambda_weights_nosort_map",
                 "lambda_weights"):
        monkeypatch.setattr(PL, name, lambda *a, _n=name: _n)
    return PL.lambda_fn(create_scorer(metric))(None, None, None, None)


@pytest.mark.parametrize("metric", ["NDCG@10", "DCG@5", "P@4", "ERR@10",
                                    "MAP", "RR@10", "BEST@10"])
def test_routing_follows_the_reference(monkeypatch, metric):
    m = create_scorer(metric).metric
    default = {"NDCG": "lambda_weights_nosort", "DCG": "lambda_weights_nosort",
               "P": "lambda_weights_nosort",
               "ERR": "lambda_weights_nosort_err",
               "MAP": "lambda_weights_nosort_map"}.get(m, "lambda_weights")
    assert _which(monkeypatch, metric, flag=False) == default
    # the flag takes the separable metrics only; ERR, MAP, RR and BEST
    # ignore it
    assert _which(monkeypatch, metric, flag=True) == (
        "lambda_weights_fused" if m in LK.SEPARABLE_METRICS else default)
    monkeypatch.setenv(FLAG, "0")
    assert not LK.supports_fused(create_scorer(metric))


def test_fit_under_the_flag_matches_the_sort_free_fit(monkeypatch):
    train = synth_dataset(n_queries=16, n_features=6, min_docs=5,
                          max_docs=30, seed=31, signal=3.0)
    scorer = create_scorer("NDCG@10")
    fits = []
    for flag in ("0", "1"):
        monkeypatch.setenv(FLAG, flag)
        r = LambdaMART(n_trees=10, n_leaves=6, early_stop=0)
        r.fit(train, scorer, device=CPU)
        fits.append(r)
    a, b = (f.ensemble.trees[0] for f in fits)
    for field in ("feature", "threshold", "left", "right", "is_leaf"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    np.testing.assert_allclose(b.output, a.output, rtol=1e-4, atol=1e-6)
    ma, mb = (float(f.fit_state.train_m[9]) for f in fits)
    assert np.isfinite(mb) and abs(ma - mb) <= 1e-3


@pytest.mark.parametrize("metric", ["NDCG@10", "DCG@5", "P@4"])
def test_fused_route_matches_the_sorted_path(metric):
    """The fused route computes the sorted path's lambdas (both take the
    ideal DCG per call), as tests/test_lambda_kernel.py holds the
    reference's kernel to its sorted path."""
    chunk = [torch.from_numpy(a) for a in _case(6, 40, seed=len(metric))]
    scorer = create_scorer(metric)
    want = PL.lambda_weights(scorer, *chunk)
    got = LK.lambda_weights_fused(scorer, *chunk)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


def test_round_step_takes_the_route_of_lambda_fn(monkeypatch):
    """``make_round_step`` builds its lambdas with ``lambda_fn`` once,
    so the flag reaches the round."""
    monkeypatch.setenv(FLAG, "1")
    seen = []
    real = PBoost.lambda_fn
    monkeypatch.setattr(PBoost, "lambda_fn",
                        lambda s: seen.append(s.metric) or real(s))
    PBoost.make_round_step(create_scorer("NDCG@10"), n_bins=8, n_leaves=4,
                           min_leaf_support=1, learning_rate=0.1,
                           pointwise=False, newton=True, n_queries=1,
                           n_vqueries=1)
    assert seen == ["NDCG"]
