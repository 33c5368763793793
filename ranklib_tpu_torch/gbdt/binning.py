"""Feature pre-binning for training and serving (ranklib_tpu.gbdt.binning;
ref: learning/tree/FeatureHistogram.java:~60).

Once per fit, each feature gets at most ``-tc`` candidate split values:
all unique values when there are few enough, else an evenly spaced grid
between min and max. A doc goes left at a split iff ``value <= threshold``;
with a per-feature grid, ``bin = searchsorted(thresholds_f, value, 'left')``
gives ``value <= thresholds_f[b]  ⟺  bin <= b``, so growth runs on integer
bins. The native C++ (the port's ``native/binner.cpp``, built at first use
by ``native.loader``) does both passes; numpy is the fallback.
"""

from __future__ import annotations

import numpy as np


def thresholds_from_uniques(vals, counts, minmax, n_threshold: int):
    """Per-feature grids from capped-unique statistics: ≤ n_threshold
    uniques → all of them, sorted; else the evenly spaced min/max grid
    with its last point pinned to the max (ref: FeatureHistogram
    construct, step = (max−min)/nThreshold). Returns (thresholds [F, B]
    f32 padded with +inf, n_bins [F] int32); B is 8, or a multiple of 128
    above 8."""
    F = len(counts)
    per_feature = []
    for f in range(F):
        if counts[f] <= n_threshold:
            thr = np.sort(vals[f][: counts[f]]).astype(np.float32)
        else:
            lo, hi = float(minmax[f, 0]), float(minmax[f, 1])
            thr = np.linspace(lo, hi, n_threshold, dtype=np.float32)
            thr[-1] = hi
        per_feature.append(thr)
    B = max(len(t) for t in per_feature)
    B = max(8, ((B + 127) // 128) * 128) if B > 8 else 8
    thresholds = np.full((F, B), np.inf, dtype=np.float32)
    n_bins = np.zeros((F,), dtype=np.int32)
    for f, t in enumerate(per_feature):
        thresholds[f, : len(t)] = t
        n_bins[f] = len(t)
    return thresholds, n_bins


def compute_thresholds(feats: np.ndarray, n_threshold: int):
    """Candidate split values of ``feats [N, F]``: (thresholds [F, B] f32
    +inf padded, n_bins [F] int32). The last real threshold of a feature
    is its max, so every training value lands in a real bin."""
    from ranklib_tpu_torch.native.loader import native_feature_uniques

    N, F = feats.shape
    nat = native_feature_uniques(np.asarray(feats, np.float32), n_threshold)
    if nat is not None:
        return thresholds_from_uniques(*nat, n_threshold)
    vals, counts, minmax = [], [], np.zeros((F, 2), np.float32)
    for f in range(F):
        u = np.unique(feats[:, f])
        vals.append(u[:n_threshold + 1])
        counts.append(len(u))
        fin = u[~np.isnan(u)]          # finite-only min/max (native rule)
        if len(fin):
            minmax[f] = (fin[0], fin[-1])
    return thresholds_from_uniques(vals, np.asarray(counts), minmax,
                                   n_threshold)


def bin_features(feats: np.ndarray, thresholds: np.ndarray) -> np.ndarray:
    """Bin of each (doc, feature) value: the smallest b with
    ``value <= thresholds[f, b]``. Values above the last threshold (and
    NaN, which sorts past every value) get the row length B: always routed
    right. Returns [N, F] int32."""
    from ranklib_tpu_torch.native.loader import native_bin_features

    out = native_bin_features(feats, thresholds)
    if out is not None:
        return out
    N, F = feats.shape
    out = np.empty((N, F), dtype=np.int32)
    for f in range(F):
        out[:, f] = np.searchsorted(thresholds[f], feats[:, f], side="left")
    return out
