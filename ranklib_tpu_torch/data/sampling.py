"""Query-level sampling for Random-Forests bagging (copy of
ranklib_tpu.data.sampling; ref: learning/Sampler.java:~10).

The same numpy ``Generator`` draws in the same order as the reference, so
every bag holds the same queries and features in both packages.
"""

from __future__ import annotations

import numpy as np

from ranklib_tpu_torch.data.dataset import Dataset


def sample_queries(ds: Dataset, rate: float, rng: np.random.Generator,
                   with_replacement: bool = True):
    """Return (sampled Dataset, out-of-bag Dataset or None, sampled
    indices): ``int(rate * Q)`` queries drawn with replacement (or a
    permutation prefix without), mirroring Sampler.doSampling."""
    Q = len(ds.queries)
    size = int(rate * Q)
    if with_replacement:
        idx = rng.integers(0, Q, size=size)
    else:
        idx = rng.permutation(Q)[:size]
    chosen = np.zeros(Q, dtype=bool)
    chosen[np.unique(idx)] = True
    sampled = [ds.queries[i] for i in idx]
    oob = [ds.queries[i] for i in range(Q) if not chosen[i]]
    return (Dataset(sampled, ds.n_features),
            Dataset(oob, ds.n_features) if oob else None, idx)


def sample_features(n_features: int, rate: float, rng: np.random.Generator):
    """Random feature subset (fids, 1-indexed, sorted) at ``rate`` without
    replacement (ref: RFRanker featureSamplingRate, default 0.3)."""
    k = max(1, int(rate * n_features))
    fids = rng.permutation(n_features)[:k] + 1
    return sorted(int(f) for f in fids)
