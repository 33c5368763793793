"""Ranking metrics as masked [B, D] tensor functions (ranklib_tpu.metrics.scorers).

Reference behaviour (ref: metric/*Scorer.java):

* NDCG/DCG: gain 2^label − 1, discount 1/log2(pos+2), truncated at k;
  ideal DCG of 0 → score 0 (ref: metric/NDCGScorer.java:~20);
* ERR: R(l) = (2^l − 1)/2^gmax, ERR@k = Σ_{r≤k} (1/r)·R_r·Π_{t<r}(1−R_t)
  (ref: metric/ERRScorer.java:~15, MAX set by -gmax, default 4);
* MAP: binary rel = label>0, AP over ALL retrieved docs, no k truncation
  (ref: metric/APScorer.java:~15);
* P@k, RR@k, Best@k per metric/{Precision,ReciprocalRank,BestAtK}Scorer;
  k <= 0 means no cutoff.

Every function takes ranked labels ``L[B, D]`` (f32, padding zeros at the
tail) and true doc counts ``n[B]``. Score functions return [B] f32;
``*_swap`` functions return the signed [B, D, D] metric change of swapping
ranked positions i and j, the closed forms LambdaMART trains through (ref:
metric/MetricScorer.java:~60). Both use the reference's f32 operations.
"""

from __future__ import annotations

import torch


def _pos(D: int, device) -> torch.Tensor:
    return torch.arange(D, dtype=torch.float32, device=device)


def _k_eff(k: int, n: torch.Tensor) -> torch.Tensor:
    """Effective cutoff per query: min(k, n), or n when k <= 0."""
    n = n.to(torch.int32)
    if k is None or k <= 0:
        return n
    return torch.clamp(n, max=int(k))


def _ink(k: int, n: torch.Tensor, D: int) -> torch.Tensor:
    """[B, D] float mask of positions inside the cutoff."""
    ke = _k_eff(k, n)
    return (torch.arange(D, device=n.device)[None, :]
            < ke[:, None]).to(torch.float32)


def _valid(n: torch.Tensor, D: int) -> torch.Tensor:
    return (torch.arange(D, device=n.device)[None, :]
            < n.to(torch.int32)[:, None]).to(torch.float32)


def _gain(L: torch.Tensor) -> torch.Tensor:
    return torch.exp2(L) - 1.0


def _discount(D: int, device) -> torch.Tensor:
    return 1.0 / torch.log2(_pos(D, device) + 2.0)


def _pair_valid(n: torch.Tensor, D: int) -> torch.Tensor:
    v = _valid(n, D)
    return v[:, :, None] * v[:, None, :]


def _sym(upper: torch.Tensor) -> torch.Tensor:
    """Mirror the upper triangle (i < j) of [B, D, D] into a symmetric
    matrix."""
    D = upper.shape[-1]
    i = torch.arange(D, device=upper.device)
    u = upper * (i[:, None] < i[None, :]).to(upper.dtype)
    return u + u.transpose(-1, -2)


def _ideal(L: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Labels sorted descending over valid positions (stable)."""
    v = _valid(n, L.shape[-1])
    key = torch.where(v > 0, -L, torch.inf)
    order = torch.sort(key, dim=-1, stable=True).indices
    return torch.gather(L, -1, order) * v


def dcg_score(L, n, k):
    D = L.shape[-1]
    w = _ink(k, n, D) * _discount(D, L.device)[None, :]
    return torch.sum(_gain(L) * w * _valid(n, D), dim=-1)


def dcg_swap(L, n, k):
    D = L.shape[-1]
    g = _gain(L) * _valid(n, D)
    w = _ink(k, n, D) * _discount(D, L.device)[None, :]
    # swap(i, j): Δ = (g_i − g_j)(w_j − w_i); symmetric by construction
    dg = g[:, :, None] - g[:, None, :]
    dw = w[:, None, :] - w[:, :, None]
    return dg * dw * _pair_valid(n, D)


def _inv_ideal(L, n, k):
    ideal = dcg_score(_ideal(L, n), n, k)
    return torch.where(ideal > 0, 1.0 / torch.where(ideal > 0, ideal, 1.0),
                       0.0)


def ndcg_score(L, n, k):
    ideal = dcg_score(_ideal(L, n), n, k)
    return torch.where(ideal > 0,
                       dcg_score(L, n, k) / torch.where(ideal > 0, ideal, 1.0),
                       0.0)


def ndcg_swap(L, n, k):
    return dcg_swap(L, n, k) * _inv_ideal(L, n, k)[:, None, None]


def _err_parts(L, n, k, gmax):
    D = L.shape[-1]
    R = (_gain(L) / (2.0 ** gmax)) * _valid(n, D)          # stopping prob
    # exclusive cumulative product Π_{t<p}(1 − R_t)
    T = torch.cat([torch.ones_like(R[:, :1]),
                   torch.cumprod(1.0 - R[:, :-1], dim=-1)], dim=-1)
    u = _ink(k, n, D) / (_pos(D, L.device)[None, :] + 1.0)  # truncated 1/rank
    return R, T, u, u * R * T


def err_score(L, n, k, gmax=4.0):
    return torch.sum(_err_parts(L, n, k, gmax)[3], dim=-1)


def err_floor(gmax: float) -> float:
    """Floor of ERR's (1 − R_i) denominator, sign kept: legitimate 1 − R
    is at least 2^−gmax, so min(1e-6, 2^−gmax/2) never moves a valid
    ratio (ref ``err_swap``, metrics/scorers.py:157). A document inside
    the floor stops the user for certain (R == 1: labels above -gmax, e.g.
    binary labels under -gmax 0); see :func:`err_stop_row`."""
    return min(1e-6, 2.0 ** (-float(gmax)) / 2.0)


def floor_den(den: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(den.abs() < eps,
                       torch.where(den < 0, -eps, eps), den)


def err_stop_row(R, T, u, Tr, Sr):
    """Swap change of the first certain-stop document i with each later
    j, without the ratio: Δ = T_i [u_i (R_j − R_i) + (R_i − R_j)·S_j
    + u_j·Q_j·(R_i (1 − R_j) − R_j (1 − R_i))], where Q_j = Π (1 − R_t)
    and S_j = Σ u_p R_p Q_p run over the documents strictly between i and
    j (``Tr``, ``Sr``). The ratio form scales terms that R_i == 1 has
    already zeroed, so it loses everything between i and j when i moves
    down (off by up to 0.5); the reference keeps that fault. Returns
    [B, D, D] for rows i, columns j."""
    Ri, Rj = R[:, :, None], R[:, None, :]
    return T[:, :, None] * (u[:, :, None] * (Rj - Ri)
                            + (Ri - Rj) * Sr[:, None, :]
                            + u[:, None, :] * Tr[:, None, :]
                            * (Ri * (1.0 - Rj) - Rj * (1.0 - Ri)))


def err_swap(L, n, k, gmax=4.0):
    D = L.shape[-1]
    R, T, u, term = _err_parts(L, n, k, gmax)
    E = torch.cumsum(term, dim=-1)
    # M[i, j] = Σ_{i<p<j} term_p = E_{j−1} − E_i (0 when j <= i+1)
    Ej1 = torch.cat([torch.zeros_like(E[:, :1]), E[:, :-1]], dim=-1)
    M = torch.clamp(Ej1[:, None, :] - E[:, :, None], min=0.0)
    eps = err_floor(gmax)
    den = floor_den(1.0 - R[:, :, None], eps)
    ratio = (1.0 - R[:, None, :]) / den
    dij = (u[:, :, None] * (R[:, None, :] - R[:, :, None]) * T[:, :, None]
           + (ratio - 1.0) * M
           + u[:, None, :] * T[:, None, :]
           * (R[:, :, None] * ratio - R[:, None, :]))
    # the first certain-stop position's row (later stop rows have T = 0):
    # products restarted after it
    pos = torch.arange(D, device=L.device)
    stop = ((1.0 - R).abs() < eps) & (_valid(n, D) > 0)
    first = torch.where(stop, pos, D).amin(dim=-1)
    after = pos[None, :] > first[:, None]
    A = torch.where(after, 1.0 - R, 1.0)
    Tr = torch.cat([torch.ones_like(A[:, :1]),
                    torch.cumprod(A[:, :-1], dim=-1)], dim=-1)
    V = torch.where(after, u * R * Tr, 0.0)
    Sr = torch.cat([torch.zeros_like(V[:, :1]),
                    torch.cumsum(V[:, :-1], dim=-1)], dim=-1)
    dij = torch.where((pos[None, :] == first[:, None])[:, :, None],
                      err_stop_row(R, T, u, Tr, Sr), dij)
    return _sym(dij) * _pair_valid(n, D)


def ap_score(L, n, k=None):
    D = L.shape[-1]
    rel = (L > 0).to(torch.float32) * _valid(n, D)
    c = torch.cumsum(rel, dim=-1)
    total = torch.sum(rel, dim=-1)
    ap = torch.sum(rel * c / (_pos(D, L.device)[None, :] + 1.0), dim=-1)
    return torch.where(total > 0, ap / torch.where(total > 0, total, 1.0), 0.0)


def ap_swap(L, n, k=None):
    D = L.shape[-1]
    rel = (L > 0).to(torch.float32) * _valid(n, D)
    c = torch.cumsum(rel, dim=-1)
    total = torch.sum(rel, dim=-1)
    inv_r = torch.where(total > 0, 1.0 / torch.where(total > 0, total, 1.0),
                        0.0)
    p1 = _pos(D, L.device)[None, :] + 1.0
    S = torch.cumsum(rel / p1, dim=-1)
    # for i < j: Δ·R = (rel_j − rel_i)·[(c_i + 1 − rel_i)/(i+1) − c_j/(j+1)
    #                                  + (S_{j−1} − S_i)]
    A = (c + 1.0 - rel) / p1
    C = c / p1
    Sj1 = torch.cat([torch.zeros_like(S[:, :1]), S[:, :-1]], dim=-1)
    core = A[:, :, None] - C[:, None, :] + (Sj1[:, None, :] - S[:, :, None])
    drel = rel[:, None, :] - rel[:, :, None]                # rel_j − rel_i
    return _sym(drel * core * inv_r[:, None, None]) * _pair_valid(n, D)


def precision_score(L, n, k):
    D = L.shape[-1]
    rel = (L > 0).to(torch.float32) * _valid(n, D)
    ke = _k_eff(k, n).to(torch.float32)
    hits = torch.sum(rel * _ink(k, n, D), dim=-1)
    return torch.where(ke > 0, hits / torch.where(ke > 0, ke, 1.0), 0.0)


def precision_swap(L, n, k):
    D = L.shape[-1]
    rel = (L > 0).to(torch.float32) * _valid(n, D)
    ink = _ink(k, n, D)
    ke = _k_eff(k, n).to(torch.float32)
    inv_k = torch.where(ke > 0, 1.0 / torch.where(ke > 0, ke, 1.0), 0.0)
    drel = rel[:, None, :] - rel[:, :, None]
    dink = ink[:, :, None] - ink[:, None, :]
    return drel * dink * inv_k[:, None, None] * _pair_valid(n, D)


def _first_rel(L, n, k):
    """Position of the first relevant doc inside the cutoff (inf: none)."""
    D = L.shape[-1]
    rel = (L > 0) & (_ink(k, n, D) > 0)
    idx = torch.where(rel, _pos(D, L.device)[None, :], torch.inf)
    return torch.amin(idx, dim=-1)


def rr_score(L, n, k):
    first = _first_rel(L, n, k)
    return torch.where(torch.isfinite(first), 1.0 / (first + 1.0), 0.0)


def rr_swap(L, n, k):
    """Closed-form RR swap by first-relevant-position case analysis."""
    D = L.shape[-1]
    v = _valid(n, D)
    ink = _ink(k, n, D)
    rel = (L > 0).to(torch.float32) * v
    f = _first_rel(L, n, k)                                  # [B]
    old = torch.where(torch.isfinite(f), 1.0 / (f + 1.0), 0.0)
    pos = _pos(D, L.device)
    # next relevant strictly after p (within the cutoff); inf when none
    idx = torch.where((rel > 0) & (ink > 0), pos[None, :], torch.inf)
    rev_cummin = torch.cummin(idx.flip(-1), dim=-1).values.flip(-1)
    nxt = torch.cat([rev_cummin[:, 1:],
                     torch.full_like(rev_cummin[:, :1], torch.inf)], dim=-1)
    ri, rj = rel[:, :, None], rel[:, None, :]
    pi = pos[None, :, None].expand(1, D, D)
    pj = pos[None, None, :].expand(1, D, D)
    ink_i, ink_j = ink[:, :, None], ink[:, None, :]
    fB = f[:, None, None]
    # promote: rel_i=0, rel_j=1 → new first = min(f, i) if i inside cutoff
    f_promote = torch.where(ink_i > 0, torch.minimum(fB, pi), fB)
    # demote: rel_i=1, rel_j=0 → changes only when i was the first rel;
    # new first = min(next rel after i, j if j inside the cutoff)
    j_cand = torch.where(ink_j > 0, pj, torch.inf)
    f_demote = torch.where((ink_i > 0) & (fB == pi),
                           torch.minimum(nxt[:, :, None], j_cand), fB)
    f_new = torch.where((ri < 0.5) & (rj > 0.5), f_promote,
                        torch.where((ri > 0.5) & (rj < 0.5), f_demote, fB))
    new = torch.where(torch.isfinite(f_new), 1.0 / (f_new + 1.0), 0.0)
    # the case analysis assumed i < j: keep the upper triangle, mirror it
    return _sym(new - old[:, None, None]) * _pair_valid(n, D)


def best_score(L, n, k):
    ink = _ink(k, n, L.shape[-1])
    best = torch.amax(torch.where(ink > 0, L, -torch.inf), dim=-1)
    return best.clamp(min=0.0) * (_k_eff(k, n) > 0)


def best_swap(L, n, k):
    D = L.shape[-1]
    ink = _ink(k, n, D)
    Lin = torch.where(ink > 0, L, -torch.inf)
    m1 = torch.amax(Lin, dim=-1)                              # top-k max
    is_max = Lin == m1[:, None]
    cnt1 = is_max.to(torch.float32).sum(dim=-1)
    m2 = torch.amax(torch.where(is_max, -torch.inf, Lin), dim=-1)
    # dropping position i from the top k: the max stays m1 unless i is the
    # unique max
    drop_max = torch.where(is_max & (cnt1[:, None] <= 1), m2[:, None],
                           m1[:, None])
    # only cross-boundary swaps (i inside k, j outside) change the set;
    # where(), not a product with 0: a fully padded row has m1 = −inf and
    # (−inf − −inf)·0 = NaN, where every other swap gives exact 0
    cross = ink[:, :, None] * (1.0 - ink[:, None, :])
    new_max = torch.maximum(drop_max[:, :, None], L[:, None, :])
    dij = torch.where(cross > 0, new_max - m1[:, None, None], 0.0)
    return _sym(dij) * _pair_valid(n, D)
