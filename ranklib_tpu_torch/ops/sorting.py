"""Stable ranking primitives (ranklib_tpu.ops.sorting).

The reference's MergeSorter (ref: utilities/MergeSorter.java:~20) is a
stable sort; stability defines RankLib's tie-breaking: equal scores keep
file order. ``torch.sort(stable=True)`` gives that contract on every
device, where ``torch.topk`` promises no tie order.
"""

from __future__ import annotations

import torch


def rank_perm(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Permutation ranking docs by score DESC, stable ties, padding last.
    scores/mask: [..., D] → int64 [..., D]."""
    key = torch.where(mask, -scores, torch.inf)
    return torch.sort(key, dim=-1, stable=True).indices


def rank_labels(labels: torch.Tensor, scores: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Labels gathered into score-descending rank order (padding → 0 tail)."""
    ranked = torch.gather(labels, -1, rank_perm(scores, mask))
    n = mask.sum(dim=-1, keepdim=True)
    pos = torch.arange(labels.shape[-1], device=labels.device)
    return torch.where(pos < n, ranked, 0.0)
