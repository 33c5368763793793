"""Batched lambda-gradient statistics (ranklib_tpu.gbdt.lambdas; ref:
LambdaMART.computePseudoResponses, learning/tree/LambdaMART.java:~300).

Per query, in the ranking by current score (desc, stable), for every doc
pair (i, j) with label_i > label_j:

    rho = 1 / (1 + exp(s_i − s_j))          (= sigmoid(s_j − s_i))
    lambda_i += rho·|Δ|,   lambda_j −= rho·|Δ|
    w_i += rho(1−rho)·|Δ|, w_j += rho(1−rho)·|Δ|

with Δ the metric's swap change. Every function takes one padded chunk
(``labels``/``scores`` [B, D] f32, ``mask`` [B, D] bool) and returns
``(lam, w)`` [B, D] in the chunk's doc order, as masked [B, D, D] tensor
programs. The sorted :func:`lambda_weights` is the reference path; the
boosting round takes the sort-free paths, which rank by compare-count
with MergeSorter's tie-break (:func:`_beats`). ``torch.einsum`` here is an
f32 batched matmul: the port never enables TF32, which would keep only
~3 decimal digits of the ERR/MAP prefix sums.
"""

from __future__ import annotations

import torch

from ranklib_tpu_torch.metrics import scorers as S

# metrics whose |Δ| factors as |A_i − A_j|·|B_i − B_j| (the sort-free
# path's per-fit scale; ref ops/lambda_kernel.py:92)
SEPARABLE_METRICS = ("NDCG", "DCG", "P")


def lambda_weights(scorer, labels, scores, mask):
    """Sorted reference path: rank, take the swap matrix on the ranked
    labels, accumulate, permute back."""
    n = mask.sum(dim=-1).to(torch.int32)
    key = torch.where(mask, -scores, torch.inf)
    order = torch.sort(key, dim=-1, stable=True).indices   # desc, pads last
    L = torch.gather(labels, -1, order)
    Sc = torch.gather(scores, -1, order)

    delta = scorer.swap_deltas(L, n).abs()                 # [B, D, D]
    P = (L[:, :, None] > L[:, None, :]).to(torch.float32)
    rho = torch.sigmoid(Sc[:, None, :] - Sc[:, :, None])  # sigmoid(s_j − s_i)
    m = P * rho * delta
    lam_ranked = m.sum(dim=2) - m.sum(dim=1)
    ww = P * (rho * (1.0 - rho)) * delta
    w_ranked = ww.sum(dim=2) + ww.sum(dim=1)

    inv = torch.argsort(order, dim=-1)                     # inverse permutation
    z = mask.to(torch.float32)
    return (torch.gather(lam_ranked, -1, inv) * z,
            torch.gather(w_ranked, -1, inv) * z)


def chunk_scale(scorer, labels, mask):
    """[B] per-query constant factor of the swap delta for the sort-free
    path, computed once per fit (labels never change): 1/idealDCG for
    NDCG, 1 for DCG and P@k."""
    if scorer.metric == "NDCG":
        n = mask.sum(dim=-1).to(torch.int32)
        return S._inv_ideal(labels, n, scorer.k)
    return torch.ones(labels.shape[0], dtype=torch.float32,
                      device=labels.device)


def _beats(scores, mask):
    """[B, D, D] strict-ranking indicator: beats[b, i, j] = 1 iff doc j
    ranks before doc i in the stable score-desc order (ties broken by
    original index, utilities/MergeSorter.java). Invalid j count 0, so
    rank_i = Σ_j beats[i, j]."""
    D = scores.shape[-1]
    idx = torch.arange(D, device=scores.device)
    si = scores[:, :, None]
    sj = scores[:, None, :]
    tie = (sj == si) & (idx[None, None, :] < idx[None, :, None])
    return (((sj > si) | tie).to(torch.float32)
            * mask.to(torch.float32)[:, None, :])


def _pair_lambdas(labels, scores, mask, delta):
    """(lam, w) from a symmetric |Δ| matrix in doc order: the shared tail
    of every sort-free path."""
    v = mask.to(torch.float32)
    P = ((labels[:, :, None] > labels[:, None, :]).to(torch.float32)
         * v[:, :, None] * v[:, None, :])
    rho = torch.sigmoid(scores[:, None, :] - scores[:, :, None])
    m = P * rho * delta
    lam = m.sum(dim=2) - m.sum(dim=1)
    ww = P * (rho * (1.0 - rho)) * delta
    w = ww.sum(dim=2) + ww.sum(dim=1)
    return lam * v, w * v


def _symmetric_from_earlier(d_el, beats):
    """|Δ| for doc pairs from the (x earlier, y later) closed form."""
    dd = d_el.abs() * beats.transpose(1, 2)                # x before y
    return dd + dd.transpose(1, 2)


def lambda_weights_nosort_err(scorer, labels, scores, mask):
    """Sort-free ERR@k (the reference's default training metric). ERR's
    swap is not product-separable, so each rank-prefix quantity of
    ``err_swap`` becomes a matvec against the beats matrix:

        rank_i = Σ_j beats[i, j]
        T_i    = Π_{j before i} (1−R_j) = exp(Σ_j beats[i, j]·log|1−R_j|)
        Elt_i  = Σ_{j before i} term_j  (term = u·R·T)

    T in log-magnitude + sign-parity form: a label above -gmax makes
    1 − R negative, and a bare log would put NaN into every lambda of the
    query where the sorted path's cumprod stays finite."""
    D = labels.shape[-1]
    v = mask.to(torch.float32)
    n = mask.sum(dim=-1).to(torch.int32)
    ke = S._k_eff(scorer.k, n).to(torch.float32)

    beats = _beats(scores, mask)                           # [B, D, D]
    rank = beats.sum(dim=2)                                # [B, D]
    R = ((torch.exp2(labels) - 1.0) / (2.0 ** scorer.gmax)) * v
    one_m_R = 1.0 - R
    # clamp only the log argument: exp(−69) underflows to ~0 in f32, so
    # 1 − R == 0 gives T = 0 like the cumprod, with no −inf·0 = NaN
    log_mag = torch.log(torch.clamp(one_m_R.abs(), min=1e-30))
    neg = (one_m_R < 0).to(torch.float32)
    # one stacked matmul: beats streams once for both prefix sums
    pre = torch.einsum("bij,bjc->bic", beats,
                       torch.stack([log_mag, neg], dim=-1))
    sign = 1.0 - 2.0 * torch.remainder(pre[..., 1], 2.0)
    T = sign * torch.exp(pre[..., 0])
    ink = ((rank < ke[:, None]) & mask).to(torch.float32)
    u = ink / (rank + 1.0)
    term = u * R * T
    Elt = torch.einsum("bij,bj->bi", beats, term)          # terms before i

    Rx = R[:, :, None]
    Ry = R[:, None, :]
    eps = S.err_floor(scorer.gmax)
    ratio = (1.0 - Ry) / S.floor_den(1.0 - Rx, eps)
    # the clip mirrors err_swap's M = max(M, 0), live only when a label
    # exceeds -gmax
    M = torch.clamp(Elt[:, None, :] - (Elt + term)[:, :, None], min=0.0)
    d_el = (u[:, :, None] * (Ry - Rx) * T[:, :, None]
            + (ratio - 1.0) * M
            + u[:, None, :] * T[:, None, :] * (Rx * ratio - Ry))
    # the first certain-stop document's row, as in err_swap: products
    # restarted after it, over the docs ranked between
    stop = (one_m_R.abs() < eps) & mask
    first = stop & (rank == torch.where(stop, rank, D).amin(dim=-1,
                                                          keepdim=True))
    after = torch.einsum("bij,bj->bi", beats, first.to(torch.float32))
    pre_r = torch.einsum("bij,bjc->bic", beats,
                         torch.stack([log_mag * after, neg * after], dim=-1))
    Tr = (1.0 - 2.0 * torch.remainder(pre_r[..., 1], 2.0)) * torch.exp(
        pre_r[..., 0])
    Sr = torch.einsum("bij,bj->bi", beats, after * u * R * Tr)
    d_el = torch.where(first[:, :, None],
                       S.err_stop_row(R, T, u, Tr, Sr), d_el)
    return _pair_lambdas(labels, scores, mask,
                         _symmetric_from_earlier(d_el, beats))


def lambda_weights_nosort_map(scorer, labels, scores, mask):
    """Sort-free MAP: the cumulative relevance count c and the harmonic
    prefix sum S of ``ap_swap`` become beats-matrix matvecs, and the
    ranked closed form maps to doc space with compare-count ranks."""
    v = mask.to(torch.float32)
    rel = (labels > 0).to(torch.float32) * v

    beats = _beats(scores, mask)
    # rank and the relevance prefix count share one pass over beats
    pre = torch.einsum("bij,bjc->bic", beats,
                       torch.stack([torch.ones_like(rel), rel], dim=-1))
    rank = pre[..., 0]
    p1 = rank + 1.0
    c = pre[..., 1] + rel                                  # inclusive
    Sv = torch.einsum("bij,bj->bi", beats, rel / p1) + rel / p1
    total = rel.sum(dim=-1)
    inv_r = torch.where(total > 0, 1.0 / torch.where(total > 0, total, 1.0),
                        0.0)

    A = (c + 1.0 - rel) / p1                               # at x (earlier)
    C = c / p1                                             # at y (later)
    between = (Sv - rel / p1)[:, None, :] - Sv[:, :, None]
    core = A[:, :, None] - C[:, None, :] + between
    d_el = (rel[:, None, :] - rel[:, :, None]) * core * inv_r[:, None, None]
    return _pair_lambdas(labels, scores, mask,
                         _symmetric_from_earlier(d_el, beats))


def lambda_weights_nosort(scorer, labels, scores, mask, scale):
    """Sort-free NDCG / DCG / P@k: the ranked position is a stable
    compare-count and the position weight follows in closed form,
    ink(rank)·1/log2(rank+2). ``scale``: [B] from :func:`chunk_scale`."""
    v = mask.to(torch.float32)
    n = mask.sum(dim=-1).to(torch.int32)
    ke = S._k_eff(scorer.k, n)

    rank = _beats(scores, mask).sum(dim=2)                 # [B, D] f32
    ink = ((rank < ke[:, None].to(torch.float32)) & mask).to(torch.float32)

    if scorer.metric == "P":
        kef = ke.to(torch.float32)
        inv_k = torch.where(kef > 0, 1.0 / torch.where(kef > 0, kef, 1.0),
                            0.0)
        A = (labels > 0).to(torch.float32) * v * inv_k[:, None]
        Bv = ink
    else:                                                  # NDCG / DCG
        A = (torch.exp2(labels) - 1.0) * v * scale[:, None]
        Bv = ink / torch.log2(rank + 2.0)

    delta = ((A[:, :, None] - A[:, None, :]).abs()
             * (Bv[:, :, None] - Bv[:, None, :]).abs())
    return _pair_lambdas(labels, scores, mask, delta)


def lambda_fn(scorer):
    """The round's lambda path (ref ``make_round_step`` routing,
    gbdt/boost.py:223-235, without the fused kernel): sort-free for
    NDCG/DCG/P (needs the per-fit scale), ERR and MAP; sorted otherwise.
    Returns ``fn(labels, scores, mask, scale)``."""
    if scorer.metric in SEPARABLE_METRICS:
        return lambda lab, sc, msk, scl: lambda_weights_nosort(
            scorer, lab, sc, msk, scl)
    if scorer.metric == "ERR":
        return lambda lab, sc, msk, scl: lambda_weights_nosort_err(
            scorer, lab, sc, msk)
    if scorer.metric == "MAP":
        return lambda lab, sc, msk, scl: lambda_weights_nosort_map(
            scorer, lab, sc, msk)
    return lambda lab, sc, msk, scl: lambda_weights(scorer, lab, sc, msk)
