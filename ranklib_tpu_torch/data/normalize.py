"""Per-query, per-feature normalizers (copy of
ranklib_tpu.data.normalize; ref: features/{SumNormalizor,
ZScoreNormalizor,LinearNormalizer}.java).

Statistics are taken PER QUERY over that query's documents, not over the
whole file:

* ``sum``:    v / Σ|v| over the query's docs (a zero-sum feature keeps 0s)
* ``zscore``: (v − μ_q) / σ_q, population σ (σ = 0 → 0)
* ``linear``: (v − min_q) / (max_q − min_q) (a degenerate range → 0)

CLI: ``-norm sum|zscore|linear``. Numpy on the host, before binning or
upload.
"""

from __future__ import annotations

import numpy as np

from ranklib_tpu_torch.utils.errors import RankLibError


def _sum_norm(feats: np.ndarray) -> np.ndarray:
    denom = np.abs(feats).sum(axis=0, keepdims=True)
    return np.where(denom > 0, feats / np.where(denom > 0, denom, 1.0), feats)


def _zscore_norm(feats: np.ndarray) -> np.ndarray:
    mean = feats.mean(axis=0, keepdims=True)
    std = feats.std(axis=0, keepdims=True)
    return np.where(std > 0, (feats - mean) / np.where(std > 0, std, 1.0), 0.0)


def _linear_norm(feats: np.ndarray) -> np.ndarray:
    mn = feats.min(axis=0, keepdims=True)
    mx = feats.max(axis=0, keepdims=True)
    rng = mx - mn
    return np.where(rng > 0, (feats - mn) / np.where(rng > 0, rng, 1.0), 0.0)


NORMALIZERS = {
    "sum": _sum_norm,
    "zscore": _zscore_norm,
    "linear": _linear_norm,
}


def get_normalizer(name: str):
    try:
        return NORMALIZERS[name.lower()]
    except KeyError:
        raise RankLibError(
            f"Unknown normalizer '{name}' (expected sum|zscore|linear)"
        ) from None


def normalize_dataset(ds, name: str) -> None:
    """Normalize every query in place."""
    fn = get_normalizer(name)
    for q in ds.queries:
        q.feats = fn(q.feats).astype(np.float32)
