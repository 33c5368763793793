"""Candidate split values and bins (RankLib's FeatureHistogram rule).

Per feature, at most ``n_threshold`` candidates: every distinct value
when there are that few, else ``n_threshold`` evenly spaced points from
the minimum to the maximum, the last pinned to the maximum. A document
goes left at a split iff its value <= the threshold, so its bin is the
first candidate it does not exceed.
"""

from __future__ import annotations

import numpy as np
import torch


def thresholds(feats: torch.Tensor, n_threshold: int) -> list:
    """Per-feature candidate values (float32 numpy arrays, ascending) of
    ``feats [N, F]``."""
    out = []
    for f in range(feats.shape[1]):
        col = feats[:, f]
        col = col[~torch.isnan(col)]
        uniq = torch.unique(col)
        if len(uniq) <= n_threshold:
            out.append(uniq.cpu().numpy().astype(np.float32))
            continue
        lo, hi = float(uniq[0]), float(uniq[-1])
        thr = np.linspace(lo, hi, n_threshold, dtype=np.float32)
        thr[-1] = hi
        out.append(thr)
    return out


def bins(feats: torch.Tensor, thr: list) -> torch.Tensor:
    """[N, F] int16 bin of every value: the first candidate it does not
    exceed (past the last: the row length)."""
    out = torch.empty(feats.shape, dtype=torch.int16, device=feats.device)
    for f, t in enumerate(thr):
        grid = torch.from_numpy(t).to(feats.device)
        out[:, f] = torch.searchsorted(grid, feats[:, f].contiguous())
    return out


def bin_of(thr_f: np.ndarray, value: float) -> tuple:
    """(bin, on_grid): the split ``value <= value`` as a bin of the
    grid ``thr_f`` (the last candidate not above it), and whether
    ``value`` is itself a candidate."""
    b = int(np.searchsorted(thr_f, np.float32(value), side="right")) - 1
    return b, bool(b >= 0 and thr_f[b] == np.float32(value))
