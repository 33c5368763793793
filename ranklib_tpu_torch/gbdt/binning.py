"""Host feature binning, the numpy fallback (ranklib_tpu.gbdt.binning.bin_features).

A doc goes left at a split iff ``value <= threshold`` (ref:
learning/tree/FeatureHistogram.java:~60). With a per-feature grid of
thresholds, ``bin = searchsorted(thresholds_f, value, side='left')``
gives ``value <= thresholds_f[b]  ⟺  bin <= b``. Serving bins against the
model's own threshold grid; the native binner (``native.loader``) does
the same in C++ and this loop is its fallback.
"""

from __future__ import annotations

import numpy as np


def bin_features(feats: np.ndarray, thresholds: np.ndarray) -> np.ndarray:
    """Bin of each (doc, feature) value: the smallest b with
    ``value <= thresholds[f, b]``. Values above the last threshold get the
    row length, and NaN sorts past every value, so it does too (always
    routed right). Returns [N, F] int64."""
    N, F = feats.shape
    out = np.empty((N, F), dtype=np.int64)
    for f in range(F):
        out[:, f] = np.searchsorted(thresholds[f], feats[:, f], side="left")
    return out
