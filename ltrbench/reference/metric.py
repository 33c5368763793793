"""NDCG@k of scored lists (RankLib's NDCGScorer): the lists ranked by
score, descending, ties in document order; DCG@k over IDCG@k, 0 where
IDCG@k is 0; the mean over every query."""

from __future__ import annotations

import torch

from ltrbench.reference.lambdas import groups, ideal_dcg, padded, ranks


def mean_ndcg(labels: torch.Tensor, scores: torch.Tensor,
              qptr: torch.Tensor, k: int, dtype=torch.float64) -> float:
    total = torch.zeros((), dtype=dtype, device=labels.device)
    for D, qidx in groups(qptr):
        didx, mask = padded(qptr, qidx, D)
        L = labels[didx].to(dtype)
        p = ranks(scores[didx].to(dtype), mask)
        disc = torch.where(p < k, 1.0 / torch.log2(p.to(dtype) + 2.0), 0.0)
        dcg = torch.where(mask, (torch.exp2(L) - 1.0) * disc, 0.0).sum(dim=1)
        ideal = ideal_dcg(L, mask, k)
        total = total + torch.where(
            ideal > 0, dcg / torch.where(ideal > 0, ideal, 1.0), 0.0).sum()
    return float(total) / (len(qptr) - 1)
