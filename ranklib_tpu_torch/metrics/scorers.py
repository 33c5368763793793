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
tail) and true doc counts ``n[B]`` and returns [B] f32, computed in the
same f32 operations as the reference. Only the score functions are
ported; the swap-delta matrices belong to the training slice.
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


def ndcg_score(L, n, k):
    ideal = dcg_score(_ideal(L, n), n, k)
    return torch.where(ideal > 0,
                       dcg_score(L, n, k) / torch.where(ideal > 0, ideal, 1.0),
                       0.0)


def err_score(L, n, k, gmax=4.0):
    D = L.shape[-1]
    R = (_gain(L) / (2.0 ** gmax)) * _valid(n, D)          # stopping prob
    # exclusive cumulative product Π_{t<p}(1 − R_t)
    T = torch.cat([torch.ones_like(R[:, :1]),
                   torch.cumprod(1.0 - R[:, :-1], dim=-1)], dim=-1)
    u = _ink(k, n, D) / (_pos(D, L.device)[None, :] + 1.0)  # truncated 1/rank
    return torch.sum(u * R * T, dim=-1)


def ap_score(L, n, k=None):
    D = L.shape[-1]
    rel = (L > 0).to(torch.float32) * _valid(n, D)
    c = torch.cumsum(rel, dim=-1)
    total = torch.sum(rel, dim=-1)
    ap = torch.sum(rel * c / (_pos(D, L.device)[None, :] + 1.0), dim=-1)
    return torch.where(total > 0, ap / torch.where(total > 0, total, 1.0), 0.0)


def precision_score(L, n, k):
    D = L.shape[-1]
    rel = (L > 0).to(torch.float32) * _valid(n, D)
    ke = _k_eff(k, n).to(torch.float32)
    hits = torch.sum(rel * _ink(k, n, D), dim=-1)
    return torch.where(ke > 0, hits / torch.where(ke > 0, ke, 1.0), 0.0)


def rr_score(L, n, k):
    D = L.shape[-1]
    rel = (L > 0) & (_ink(k, n, D) > 0)
    idx = torch.where(rel, _pos(D, L.device)[None, :], torch.inf)
    first = torch.amin(idx, dim=-1)                       # inf when none
    return torch.where(torch.isfinite(first), 1.0 / (first + 1.0), 0.0)


def best_score(L, n, k):
    ink = _ink(k, n, L.shape[-1])
    best = torch.amax(torch.where(ink > 0, L, -torch.inf), dim=-1)
    return best.clamp(min=0.0) * (_k_eff(k, n) > 0)
