"""The port's fused lambda route (ranklib_tpu_torch.ops.lambda_kernel)
against the reference's Pallas kernel.

The same numpy-seeded chunks go through the reference's
``lambda_weights_fused`` in interpret mode (as tests/test_lambda_kernel.py
runs it on the CPU) and the port's ``lambda_weights_fused``; a fit's
one-launch round (``lambda_round``, whose CPU route is that per-chunk
path on every bucket chunk) goes through the reference chunk by chunk.
Tolerance atol 2e-5, rtol 1e-4, the one tests/test_lambda_kernel.py:38-41
holds the reference's kernel to (f32 pair sums in another order), at
every D. The CUDA kernel runs only on a card; chip_smoke.py holds it to
the plain version there. Here numpy emulations pin what it computes: its
compare-count rank against the stable sort, A and B from the per-fit
factors bit for bit against the per-call vectors, and its per-query pair
loop against the plain version. Then the routing: the opt-in flag, the
metrics it leaves alone, the sorted path the fused route must agree
with, and a whole fit under the flag.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ranklib_tpu.metrics.base import create_scorer as ref_create_scorer
from ranklib_tpu.ops import lambda_kernel as RK
from ranklib_tpu_torch.data.dataset import flatten_meta
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


def _round_data(monkeypatch, metric, seed, n_queries=9, max_docs=40,
                gmax=4, n_pad_docs=5):
    """A fit's ``BoostData`` under the flag (its ``fused`` field) on a
    small seeded dataset with pad documents, and the round's scores: N(0,1)
    rounded to quarters (score ties), with a +0.0 and a -0.0 in the first
    query."""
    monkeypatch.setenv(FLAG, "1")
    ds = synth_dataset(n_queries=n_queries, n_features=3, min_docs=2,
                       max_docs=max_docs, gmax=gmax, seed=seed)
    labels, qptr = flatten_meta(ds)
    N = len(labels)
    labels_pad = np.concatenate([labels, np.zeros(n_pad_docs, np.float32)])
    data, Npad, _ = PBoost.make_boost_data(
        ds, np.zeros((N + n_pad_docs, 1), np.uint8), labels_pad, N, None,
        None, CPU, scorer=create_scorer(metric))
    rng = np.random.default_rng(seed + 1)
    scores = (np.round(rng.normal(size=Npad + 1) * 4) / 4).astype(np.float32)
    scores[qptr[0]:qptr[0] + 2] = [0.0, -0.0]
    return data, torch.from_numpy(scores), qptr


def _emulate_round(rd, scores):
    """What csrc/lambda_pairs.cu computes, query by query in document
    order: the stable compare-count rank, A and B from the per-fit
    factors, then for each document p the pair loop over the query's
    documents with f32 terms and f64 winner and loser sums kept apart,
    lam = winner − loser, rounded to f32 once. Pad documents 0."""
    f32 = np.float32
    labels, s = rd.labels.numpy(), scores.numpy()[:rd.labels.shape[0]]
    qptr, qfac = rd.qptr.numpy(), rd.qfac.numpy()
    keff, disc = rd.keff.numpy(), rd.disc.numpy()
    lam = np.zeros(labels.shape, f32)
    w = np.zeros(labels.shape, f32)
    for q in range(len(qptr) - 1):
        b, e = qptr[q], qptr[q + 1]
        L, sc = labels[b:e], s[b:e]
        rank = _compare_count_rank(sc, np.ones(e - b, bool))
        g = ((L > 0).astype(f32) if rd.scorer.metric == "P"
             else np.exp2(L).astype(f32) - f32(1))
        A = (g.astype(np.float64) * qfac[q]).astype(f32)
        B = np.where(rank < keff[q], disc[np.minimum(rank, len(disc) - 1)],
                     f32(0)).astype(f32)
        for p in range(e - b):
            other = L != L[p]
            delta = np.abs(A[p] - A) * np.abs(B[p] - B)
            wins = L[p] > L
            x = np.where(wins, sc - sc[p], sc[p] - sc)
            with np.errstate(over="ignore"):
                rho = f32(1) / (f32(1) + np.exp(-x))
            t = (rho * delta).astype(np.float64)
            tw = ((rho * (f32(1) - rho)) * delta).astype(np.float64)
            win, lose = other & wins, other & ~wins
            lam[b + p] = f32(t[win].sum() - t[lose].sum())
            w[b + p] = f32(tw[win].sum() + tw[lose].sum())
    return lam, w


def _compare_count_rank(s, valid):
    """The kernel's rank: #{q: s_q > s_p} + #{q < p: s_q == s_p} over the
    valid documents."""
    i = np.arange(len(s))
    before = (s[None, :] > s[:, None]) | ((s[None, :] == s[:, None])
                                          & (i[None, :] < i[:, None]))
    return (before & valid[None, :]).sum(axis=1)


@pytest.mark.parametrize("metric", ["NDCG@10", "DCG@5", "P@4", "P@0"])
def test_kernel_loop_equals_plain_pair_block(monkeypatch, metric):
    """A Python emulation of the one-launch kernel's per-query loop equals
    the round's plain version (the per-chunk fused route)."""
    data, scores, _ = _round_data(monkeypatch, metric, seed=4)
    plain = LK.lambda_round_plain(data.fused, scores)
    emu = _emulate_round(data.fused, scores)
    for g, w in zip(plain, emu):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=1e-5)
        assert not g.numpy()[-5:].any()              # pad documents


@pytest.mark.parametrize("metric", ["NDCG@10", "NDCG@3", "DCG@5", "P@4",
                                    "P@0"])
def test_round_plain_matches_reference_kernel_chunk_by_chunk(monkeypatch,
                                                             metric):
    """The one-launch round's plain route against the reference's
    ``lambda_weights_fused`` in interpret mode on every bucket chunk of
    the fit."""
    data, scores, _ = _round_data(monkeypatch, metric, seed=7)
    lam, w = LK.lambda_round(data.fused, scores)
    ref_scorer = ref_create_scorer(metric)
    for lab, msk, didx in data.tb:
        want = RK.lambda_weights_fused(
            ref_scorer, jnp.asarray(lab.numpy()),
            jnp.asarray(scores[didx].numpy()), jnp.asarray(msk.numpy()),
            interpret=True)
        m = msk.numpy()
        for got, ref in zip((lam, w), want):
            np.testing.assert_allclose(got[didx].numpy()[m],
                                       np.asarray(ref)[m], **TOL)


@pytest.mark.parametrize("metric", ["NDCG@10", "NDCG@3", "DCG@5", "P@4",
                                    "P@0", "NDCG@0"])
def test_per_fit_factors_equal_per_call_vectors(monkeypatch, metric):
    """A and B built the kernel's way — 2^L − 1 (or [L > 0]) times the
    per-fit factor, the per-fit discount table at the compare-count rank
    inside k_eff — equal ``separable_vectors``' per-call vectors on the
    ranked chunk, bit for bit."""
    data, scores, qptr = _round_data(monkeypatch, metric, seed=11,
                                     max_docs=70)
    rd = data.fused
    qfac, keff, disc = rd.qfac.numpy(), rd.keff.numpy(), rd.disc.numpy()
    assert rd.max_docs == int(np.diff(qptr).max()) == disc.shape[0]
    # the kernel's blocks take the queries widest first, every one once
    sizes = np.diff(qptr)[rd.order.numpy()]
    assert sorted(rd.order.tolist()) == list(range(len(qptr) - 1))
    assert (np.diff(sizes) <= 0).all()
    f32 = np.float32
    for lab, msk, didx in data.tb:
        sc = scores[didx]
        key = torch.where(msk, -sc, torch.inf)
        order = torch.sort(key, dim=-1, stable=True).indices
        L = torch.gather(lab, -1, order)
        A, B = LK.separable_vectors(rd.scorer, L, msk.sum(-1).int())
        for row in range(lab.shape[0]):
            m = msk[row].numpy()
            if not m.any():
                continue
            q = np.searchsorted(qptr, int(didx[row, 0]), side="right") - 1
            lr = lab[row].numpy()[m]
            rank = _compare_count_rank(sc[row].numpy()[m], np.ones(m.sum(),
                                                                   bool))
            g = ((lr > 0).astype(f32) if rd.scorer.metric == "P"
                 else np.exp2(lr).astype(f32) - f32(1))
            a = (g.astype(np.float64) * qfac[q]).astype(f32)
            b = np.where(rank < keff[q], disc[rank], f32(0))
            # ranked slot r holds the document of rank r
            np.testing.assert_array_equal(A[row].numpy()[rank], a)
            np.testing.assert_array_equal(B[row].numpy()[rank], b)


def test_compare_count_rank_is_the_stable_sort_order():
    """The kernel's rank equals the position in ``torch.sort(stable=True)``
    of ``where(mask, −s, +inf)``: ties by document order, ±0.0 equal, pads
    last."""
    rng = np.random.default_rng(5)
    for _ in range(20):
        D = int(rng.integers(1, 40))
        s = (np.round(rng.normal(size=D) * 2) / 2).astype(np.float32)
        s[rng.random(D) < 0.2] = 0.0
        s[rng.random(D) < 0.2] = -0.0
        valid = np.arange(D) < int(rng.integers(1, D + 1))
        key = torch.where(torch.from_numpy(valid), -torch.from_numpy(s),
                          torch.inf)
        order = torch.sort(key, stable=True).indices.numpy()
        pos = np.empty(D, np.int64)
        pos[order] = np.arange(D)
        rank = _compare_count_rank(s, valid)
        np.testing.assert_array_equal(rank[valid], pos[valid])


def test_wrapper_checks_inputs_and_counts_only_kernel_launches(monkeypatch):
    data, scores, _ = _round_data(monkeypatch, "NDCG@10", seed=1)
    rd = data.fused
    before = LK.lambda_round.launches
    LK.lambda_round(rd, scores)
    assert LK.lambda_round.launches == before          # CPU: plain version
    bad = [
        lambda: LK.lambda_round(rd, scores.double()),
        lambda: LK.lambda_round(rd, scores[:4]),
        lambda: LK.lambda_round(rd, torch.stack([scores, scores], 1)[:, 0]),
        # neither CPU nor CUDA: raises, never falls back to the plain path
        lambda: LK.lambda_round(rd, scores.to("meta")),
        # launch_args only builds a CUDA launch
        lambda: LK.launch_args(rd, scores),
    ]
    for call in bad:
        with pytest.raises(RankLibError):
            call()


def _which(monkeypatch, metric, flag):
    """The path a round takes: ``"lambda_round"`` (the fused route, one
    launch a round, which ``make_round_step`` takes when ``make_boost_data``
    built its per-fit data) or the name of the path ``lambda_fn`` routes
    each chunk to."""
    if flag:
        monkeypatch.setenv(FLAG, "1")
    else:
        monkeypatch.delenv(FLAG, raising=False)
    for name in ("lambda_weights_nosort", "lambda_weights_nosort_err",
                 "lambda_weights_nosort_map", "lambda_weights"):
        monkeypatch.setattr(PL, name, lambda *a, _n=name: _n)
    scorer = create_scorer(metric)
    ds = synth_dataset(n_queries=3, n_features=2, seed=2)
    labels, _ = flatten_meta(ds)
    N = labels.shape[0]
    data, _, _ = PBoost.make_boost_data(ds, np.zeros((N, 1), np.uint8),
                                        labels, N, None, None, CPU,
                                        scorer=scorer)
    if data.fused is not None:
        return "lambda_round"
    return PL.lambda_fn(scorer)(None, None, None, None)


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
        "lambda_round" if m in LK.SEPARABLE_METRICS else default)
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
