"""The port's swap matrices and lambda gradients against the reference's.

Every metric's closed-form swap matrix (NDCG, DCG, ERR, MAP, P, RR, BEST)
and every lambda path (sorted for all metrics; sort-free for NDCG, DCG, P,
ERR and MAP) run on the same numpy-seeded chunks in both packages: score
ties (MergeSorter's lower-index-first order), padded rows and slots,
P@k with k <= 0. Tolerance 1e-5 (f32; sigmoid, einsum and sum orders
differ between the two frameworks).

Where the reference is wrong the port is held to a float64 brute-force
swap instead: a document with R == 1 (binary labels under -gmax 0) stops
the user for certain, and the reference's ratio form loses the terms
ranked between it and its swap partner.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ranklib_tpu.gbdt import lambdas as RL
from ranklib_tpu.metrics.base import create_scorer as ref_create_scorer
from ranklib_tpu_torch.gbdt import lambdas as PL
from ranklib_tpu_torch.metrics.base import create_scorer

METRICS = ["NDCG", "DCG", "ERR", "MAP", "P", "RR", "BEST"]
TOL = dict(atol=1e-5, rtol=1e-5)


def _chunk(B, D, seed, max_label=4, binary=False):
    """Labels, quantized scores (ties) and a mask with padded slots, one
    fully padded row and one all-zero-label row."""
    rng = np.random.default_rng(seed)
    hi = 2 if binary else max_label + 1
    labels = rng.integers(0, hi, size=(B, D)).astype(np.float32)
    scores = (np.round(rng.random((B, D)) * 4) / 4).astype(np.float32)
    n = rng.integers(1, D + 1, size=B)
    n[0] = 0                                       # fully padded row
    mask = np.arange(D)[None, :] < n[:, None]
    labels[1] = 0.0                                # no relevant doc
    labels = np.where(mask, labels, 0.0).astype(np.float32)
    return labels, scores, mask


def _ranked(labels, scores, mask):
    order = np.argsort(np.where(mask, -scores, np.inf), axis=1,
                       kind="stable")
    L = np.where(mask.sum(1, keepdims=True) > np.arange(labels.shape[1]),
                 np.take_along_axis(labels, order, 1), 0.0)
    return L.astype(np.float32), mask.sum(1).astype(np.int32)


def _scorers(metric, k, gmax=4.0):
    name = metric if metric == "MAP" else f"{metric}@{k}"
    return ref_create_scorer(name, gmax), create_scorer(name, gmax)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [1, 3, 10, 0])
def test_swap_matrices_match_reference(metric, k):
    L, n = _ranked(*_chunk(6, 12, seed=len(metric) + k))
    ref, port = _scorers(metric, k)
    want = np.asarray(ref.swap_deltas(jnp.asarray(L), jnp.asarray(n)))
    got = port.swap_deltas(torch.from_numpy(L), torch.from_numpy(n)).numpy()
    assert got.shape == want.shape == (6, 12, 12)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got[0], 0.0)     # fully padded row


@pytest.mark.parametrize("metric", METRICS)
def test_score_ranked_matches_reference(metric):
    L, n = _ranked(*_chunk(6, 12, seed=3))
    ref, port = _scorers(metric, 5)
    np.testing.assert_allclose(
        port.score_ranked(torch.from_numpy(L), torch.from_numpy(n)).numpy(),
        np.asarray(ref.score_ranked(jnp.asarray(L), jnp.asarray(n))), **TOL)


def _lambdas(ref_fn, port_fn, metric, k, chunk, gmax=4.0, scaled=False):
    labels, scores, mask = chunk
    ref, port = _scorers(metric, k, gmax)
    jl, js, jm = map(jnp.asarray, chunk)
    tl, ts, tm = map(torch.from_numpy, chunk)
    if scaled:
        want = ref_fn(ref, jl, js, jm, RL.chunk_scale(ref, jl, jm))
        got = port_fn(port, tl, ts, tm, PL.chunk_scale(port, tl, tm))
    else:
        want = ref_fn(ref, jl, js, jm)
        got = port_fn(port, tl, ts, tm)
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [3, 10])
def test_sorted_lambdas_match_reference(metric, k):
    _lambdas(RL.lambda_weights, PL.lambda_weights, metric, k,
             _chunk(5, 16, seed=k))


@pytest.mark.parametrize("metric", ["NDCG", "DCG", "P"])
@pytest.mark.parametrize("k", [0, 3, 10])
def test_nosort_separable_lambdas_match_reference(metric, k):
    """k = 0 is no cutoff for every metric, P@k included."""
    _lambdas(RL.lambda_weights_nosort, PL.lambda_weights_nosort, metric, k,
             _chunk(5, 16, seed=20 + k), scaled=True)


@pytest.mark.parametrize("k", [3, 10])
def test_nosort_err_and_map_match_reference(k):
    chunk = _chunk(5, 16, seed=30 + k)
    _lambdas(RL.lambda_weights_nosort_err, PL.lambda_weights_nosort_err,
             "ERR", k, chunk)
    _lambdas(RL.lambda_weights_nosort_map, PL.lambda_weights_nosort_map,
             "MAP", 0, chunk)


def test_nosort_equals_sorted_in_the_port():
    """Sort-free and sorted paths are the same statistics."""
    chunk = tuple(map(torch.from_numpy, _chunk(5, 16, seed=41)))
    for metric in ("NDCG", "DCG", "P", "ERR", "MAP"):
        port = create_scorer(metric if metric == "MAP" else f"{metric}@5")
        fn = PL.lambda_fn(port)
        scale = PL.chunk_scale(port, chunk[0], chunk[2])
        for g, w in zip(fn(*chunk, scale), PL.lambda_weights(port, *chunk)):
            torch.testing.assert_close(g, w, **TOL)


def test_chunk_scale_matches_reference():
    labels, _, mask = _chunk(6, 12, seed=8)
    for metric in ("NDCG", "DCG", "P"):
        ref, port = _scorers(metric, 5)
        np.testing.assert_allclose(
            PL.chunk_scale(port, torch.from_numpy(labels),
                           torch.from_numpy(mask)).numpy(),
            np.asarray(RL.chunk_scale(ref, jnp.asarray(labels),
                                      jnp.asarray(mask))), **TOL)


def test_labels_above_gmax_stay_finite_and_match_reference():
    """Labels 0-4 under -gmax 1: 1 − R < 0 (the sign-parity path)."""
    chunk = _chunk(5, 12, seed=9)
    _lambdas(RL.lambda_weights_nosort_err, PL.lambda_weights_nosort_err,
             "ERR", 10, chunk, gmax=1.0)


# ---- the ERR floor at R == 1, against a float64 brute-force swap -------

def _err64(L, k, gmax):
    R = (2.0 ** L - 1.0) / 2.0 ** gmax
    total, T = 0.0, 1.0
    for r in range(len(L)):
        if r < k:
            total += R[r] * T / (r + 1)
        T *= 1.0 - R[r]
    return total


def _brute_swap(L, k, gmax):
    D = len(L)
    base = _err64(L, k, gmax)
    out = np.zeros((D, D))
    for i in range(D):
        for j in range(D):
            M = L.copy()
            M[i], M[j] = M[j], M[i]
            out[i, j] = _err64(M, k, gmax) - base
    return out


@pytest.mark.parametrize("k", [1, 3, 10])
def test_err_swap_at_gmax_zero_matches_brute_force(k):
    rng = np.random.default_rng(k)
    for _ in range(20):
        n = int(rng.integers(2, 12))
        L = rng.integers(0, 2, n).astype(np.float64)
        got = create_scorer(f"ERR@{k}", gmax=0.0).swap_deltas(
            torch.tensor(L, dtype=torch.float32)[None],
            torch.tensor([n]))[0].double().numpy()
        np.testing.assert_allclose(got, _brute_swap(L, k, 0.0), atol=1e-6)


def test_nosort_err_lambdas_at_gmax_zero_match_brute_force():
    rng = np.random.default_rng(5)
    scorer = create_scorer("ERR@10", gmax=0.0)
    D = 12
    for _ in range(20):
        n = int(rng.integers(2, D + 1))
        lab = np.zeros(D)
        lab[:n] = rng.integers(0, 2, n)
        s = np.zeros(D)
        s[:n] = np.round(rng.random(n) * 4) / 4          # ties
        m = np.arange(D) < n
        order = np.argsort(np.where(m, -s, np.inf), kind="stable")
        delta = _brute_swap(lab[order][:n], 10, 0.0)     # ranked space
        lam, w = np.zeros(D), np.zeros(D)
        for a in range(n):
            for c in range(n):
                i, j = order[a], order[c]
                if lab[i] > lab[j]:
                    d = abs(delta[a, c])
                    rho = 1.0 / (1.0 + np.exp(s[i] - s[j]))
                    lam[i] += rho * d
                    lam[j] -= rho * d
                    w[i] += rho * (1.0 - rho) * d
                    w[j] += rho * (1.0 - rho) * d
        args = (torch.tensor(lab, dtype=torch.float32)[None],
                torch.tensor(s, dtype=torch.float32)[None],
                torch.tensor(m)[None])
        for fn in (PL.lambda_weights_nosort_err, PL.lambda_weights):
            got_l, got_w = fn(scorer, *args)
            np.testing.assert_allclose(got_l[0].numpy(), lam, atol=1e-6)
            np.testing.assert_allclose(got_w[0].numpy(), w, atol=1e-6)
