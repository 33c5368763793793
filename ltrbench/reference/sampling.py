"""Random Forests' bag draws (RankLib's Sampler and RFRanker): a frozen
copy of the rule, so that the reference redraws every bag itself.

One numpy ``Generator`` seeded with the ranker's seed draws, bag after
bag: ``int(srate·Q)`` query indices with replacement, then a permutation
of the F features whose first ``max(1, int(frate·F))`` are the bag's.
"""

from __future__ import annotations

import numpy as np


def draw_bags(n_queries: int, n_features: int, n_bags: int, srate: float,
              frate: float, seed: int) -> list:
    """[(query multiplicities [Q] int64, feature mask [F] bool)] of every
    bag, in bag order."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_bags):
        idx = rng.integers(0, n_queries, size=int(srate * n_queries))
        k = max(1, int(frate * n_features))
        fids = rng.permutation(n_features)[:k]
        mask = np.zeros(n_features, bool)
        mask[fids] = True
        out.append((np.bincount(idx, minlength=n_queries), mask))
    return out
