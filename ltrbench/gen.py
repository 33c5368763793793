"""The training-set generator: one general reader of the traffic files.

A traffic file (``traffic/<mix>.json``) gives the shape of a public
learning-to-rank dataset: queries per split, the list-length
distribution, width, feature presence and grades. :func:`generate` draws
a dataset of that shape from ``--seed``:

* list lengths are the distribution's quantiles at (i + 0.5) / Q, so
  every seed trains on the same multiset of lengths (the same padded
  work) and only their order changes with the seed;
* features are N(0, 1) float32, each present with probability
  ``presence`` (absent ones read 0), drawn on ``device`` with a
  ``torch.Generator`` in a few large calls; only the first
  ``active_features`` (all, by default) carry values, the others read 0;
* grades 0 .. grades-1 are equal quantiles, within each query, of a
  planted linear score plus N(0, 1) noise (the repository's synthetic
  LETOR draws, with rank-based quantiles).

Plain torch and numpy: the generator imports nothing of the program, so
the program and the reference read the same arrays.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

@dataclass
class Split:
    """One split of a generated dataset, on the host."""

    feats: np.ndarray     # [N, F] float32
    labels: np.ndarray    # [N] float32 grades
    qptr: np.ndarray      # [Q + 1] int64 query offsets

    @property
    def n_queries(self) -> int:
        return len(self.qptr) - 1

    @property
    def n_docs(self) -> int:
        return int(self.qptr[-1])


def list_lengths(n_queries: int, dist: dict) -> np.ndarray:
    """The fixed multiset of list lengths of ``n_queries`` queries: the
    log-normal quantiles at (i + 0.5) / Q, rounded and clipped to
    [min, max]. ``dist``: {"mean", "sigma", "min", "max"}."""
    sigma = float(dist["sigma"])
    mu = math.log(float(dist["mean"])) - sigma * sigma / 2.0
    p = (torch.arange(n_queries, dtype=torch.float64) + 0.5) / n_queries
    z = torch.special.ndtri(p)
    n = torch.round(torch.exp(mu + sigma * z)).numpy()
    return np.clip(n, int(dist["min"]), int(dist["max"])).astype(np.int64)


def _split(g: torch.Generator, lengths: np.ndarray, w: torch.Tensor,
           tr: dict, device: torch.device) -> Split:
    perm = torch.randperm(len(lengths), generator=g, device=device)
    n = torch.from_numpy(lengths).to(device)[perm]
    Q, N, F = len(lengths), int(lengths.sum()), int(tr["features"])
    qptr = torch.zeros(Q + 1, dtype=torch.int64, device=device)
    qptr[1:] = torch.cumsum(n, 0)
    feats = torch.randn((N, F), generator=g, device=device,
                        dtype=torch.float32)
    feats[:, int(tr.get("active_features", F)):] = 0.0
    presence = float(tr.get("presence", 1.0))
    if presence < 1.0:
        feats *= torch.rand((N, F), generator=g, device=device) < presence
    noise = torch.randn(N, generator=g, device=device, dtype=torch.float32)
    raw = float(tr["signal"]) * (feats @ w) + noise
    # grade = the doc's quantile band inside its query: sort by raw, then
    # stably by query, and read each doc's ascending position
    qid = torch.repeat_interleave(torch.arange(Q, device=device), n)
    order = torch.sort(raw, stable=True).indices
    order = order[torch.sort(qid[order], stable=True).indices]
    pos = torch.empty(N, dtype=torch.int64, device=device)
    pos[order] = torch.arange(N, device=device) - qptr[qid[order]]
    grades = int(tr["grades"])
    labels = torch.div(pos * grades, n[qid], rounding_mode="floor")
    return Split(feats.cpu().numpy(), labels.to(torch.float32).cpu().numpy(),
                 qptr.cpu().numpy())


def generate(tr: dict, seed: int, device: torch.device,
             with_validation: bool = True) -> tuple:
    """(train Split, validation Split or None) of traffic ``tr`` for
    ``seed``; the same seed gives the same arrays on the same device."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    F = int(tr["features"])
    w = torch.randn(F, generator=g, device=device, dtype=torch.float64)
    w[int(tr.get("active_features", F)):] = 0.0
    w = (w / w.norm()).to(torch.float32)
    dist = tr["docs_per_query"]
    train = _split(g, list_lengths(int(tr["train_queries"]), dist), w, tr,
                   device)
    vali = None
    if with_validation and int(tr.get("validation_queries", 0)) > 0:
        vali = _split(g, list_lengths(int(tr["validation_queries"]), dist),
                      w, tr, device)
    return train, vali
