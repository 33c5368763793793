"""LambdaMART's NDCG@k lambda gradients on the sorted ranking (RankLib's
LambdaMART.computePseudoResponses).

Each query is ranked by score, descending, ties in document order (a
stable sort, RankLib's MergeSorter). For every pair (i, j) with
label_i > label_j, with |Δ| the NDCG@k change of swapping their ranks:

    rho  = 1 / (1 + exp(s_i - s_j))
    λ_i += rho·|Δ|,          λ_j -= rho·|Δ|
    w_i += rho(1 - rho)·|Δ|, w_j += rho(1 - rho)·|Δ|

|Δ| = |g_i - g_j|·|d(p_i) - d(p_j)| / IDCG@k, with gain g = 2^label - 1,
discount d(p) = 1/log2(p + 2) for ranks p < k and 0 below, and IDCG@k
the DCG@k of the labels sorted descending (0 gives |Δ| = 0).
"""

from __future__ import annotations

import torch

# elements of one [rows, D, D] pair tensor
_PAIRS = 1 << 24


def groups(qptr: torch.Tensor, width: int = 32) -> list:
    """Queries grouped by their length rounded up to ``width``:
    [(D, query indices)], each group's lists padded to D."""
    n = qptr[1:] - qptr[:-1]
    D = (n + width - 1) // width * width
    return [(int(d), torch.nonzero(D == d).flatten())
            for d in torch.unique(D).tolist()]


def padded(qptr: torch.Tensor, qidx: torch.Tensor, D: int):
    """(doc index [b, D], mask [b, D]) of queries ``qidx`` padded to D
    (pad slots index doc 0 and are masked out)."""
    start = qptr[qidx]
    n = qptr[qidx + 1] - start
    pos = torch.arange(D, device=qptr.device)
    mask = pos[None, :] < n[:, None]
    return torch.where(mask, start[:, None] + pos[None, :], 0), mask


def ideal_dcg(labels: torch.Tensor, mask: torch.Tensor, k: int):
    """[b] DCG@k of each row's labels sorted descending."""
    D = labels.shape[1]
    top = torch.sort(torch.where(mask, labels, -1.0), dim=1,
                     descending=True).values
    kk = min(k, D)
    gain = torch.where(top[:, :kk] >= 0, torch.exp2(top[:, :kk]) - 1.0, 0.0)
    disc = 1.0 / torch.log2(torch.arange(kk, device=labels.device,
                                         dtype=labels.dtype) + 2.0)
    return (gain * disc).sum(dim=1)


def ranks(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[b, D] rank of each document (0 = first): stable sort by score,
    descending, pads last."""
    key = torch.where(mask, -scores, torch.inf)
    order = torch.sort(key, dim=1, stable=True).indices
    r = torch.empty_like(order)
    r.scatter_(1, order, torch.arange(order.shape[1], device=order.device)
               .expand_as(order).contiguous())
    return r


def ndcg_lambdas(labels: torch.Tensor, scores: torch.Tensor,
                 qptr: torch.Tensor, k: int, dtype=torch.float64):
    """(λ [N], w [N]) in ``dtype`` of every document of the flat lists
    (``labels``/``scores`` [N], ``qptr`` [Q + 1])."""
    dev = labels.device
    N = labels.shape[0]
    lam = torch.zeros(N, dtype=dtype, device=dev)
    wt = torch.zeros(N, dtype=dtype, device=dev)
    for D, qidx in groups(qptr):
        rows = max(1, _PAIRS // (D * D))
        for lo in range(0, len(qidx), rows):
            didx, mask = padded(qptr, qidx[lo:lo + rows], D)
            L = labels[didx].to(dtype)
            s = scores[didx].to(dtype)
            inv = ideal_dcg(L, mask, k)
            inv = torch.where(inv > 0, 1.0 / torch.where(inv > 0, inv, 1.0),
                              0.0)
            p = ranks(s, mask)
            disc = torch.where(p < k, 1.0 / torch.log2(p.to(dtype) + 2.0),
                               0.0)
            g = (torch.exp2(L) - 1.0) * inv[:, None]
            pair = ((L[:, :, None] > L[:, None, :]) & mask[:, :, None]
                    & mask[:, None, :])
            delta = ((g[:, :, None] - g[:, None, :]).abs()
                     * (disc[:, :, None] - disc[:, None, :]).abs())
            delta = torch.where(pair, delta, 0.0)
            rho = 1.0 / (1.0 + torch.exp(s[:, :, None] - s[:, None, :]))
            m = rho * delta
            lam_b = m.sum(dim=2) - m.sum(dim=1)
            h = rho * (1.0 - rho) * delta
            w_b = h.sum(dim=2) + h.sum(dim=1)
            lam.index_put_((didx[mask],), lam_b[mask])
            wt.index_put_((didx[mask],), w_b[mask])
    return lam, wt
