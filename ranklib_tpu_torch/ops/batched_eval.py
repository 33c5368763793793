"""Batched metric evaluation of linear score functions on one device
(ranklib_tpu.ops.batched_eval).

Coordinate Ascent (line-search candidates) and AdaRank (one weak ranker a
feature) evaluate the mean metric of MANY candidate weight vectors at
once: the scores of every candidate are one ``[B, D, F] x [F, C]`` matrix
product a bucket chunk (``torch.matmul``, as the reference leaves its
product to XLA outside any Pallas kernel), and the metric runs once over
the candidates folded into the row axis ``[B·C, D]`` where the reference
vmaps it.

The candidate metrics decide on gains of ~``-tolerance`` (1e-3), so the
products run in full f32: :func:`full_f32_products` turns TF32 (~1e-3
relative) off around them.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ranklib_tpu_torch.data.dataset import Dataset, flatten, iter_buckets
from ranklib_tpu_torch.metrics.base import MetricScorer

# padded docs per bucket chunk: bounds the [rows, D, C] candidate-score
# temporary (~136 MB f32 at C = 260, Coordinate Ascent's 5 restarts x 52)
_DOC_BUDGET = 1 << 17


@contextlib.contextmanager
def full_f32_products():
    """Full-f32 matrix products inside the block (TF32 off), restored on
    exit."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def candidate_metrics(scorer: MetricScorer, feats: torch.Tensor,
                      labels: torch.Tensor, mask: torch.Tensor,
                      W: torch.Tensor) -> torch.Tensor:
    """``feats [B, D, F]``, ``W [F, C]`` → per-query metric ``[B, C]`` of
    each candidate's scores ``feats @ W``."""
    B, D, _ = feats.shape
    C = W.shape[1]
    sc = torch.matmul(feats, W)                          # [B, D, C]
    sc = sc.transpose(1, 2).reshape(B * C, D)
    lab = labels[:, None, :].expand(B, C, D).reshape(B * C, D)
    msk = mask[:, None, :].expand(B, C, D).reshape(B * C, D)
    return scorer.score_from_scores(lab, sc, msk).view(B, C)


class LinearMetricEvaluator:
    """A dataset's padded feature buckets on ``device``, chunked to
    ``_DOC_BUDGET`` padded documents; evaluates candidate weight
    matrices. ``buckets``: (feats [rows, D, F], labels, mask, qidx) with
    qidx the chunk's real rows' query indices (host numpy)."""

    def __init__(self, ds: Dataset, scorer: MetricScorer,
                 device: torch.device):
        self.scorer = scorer
        self.device = device
        self.n_queries = len(ds.queries)
        self.n_features = ds.n_features
        self.buckets = []
        for b in iter_buckets(ds, with_feats=True):
            rows = max(1, min(b.B, _DOC_BUDGET // b.D))
            for lo in range(0, b.B, rows):
                hi = min(lo + rows, b.B)
                pad = ((0, rows - (hi - lo)), (0, 0))
                self.buckets.append((
                    torch.from_numpy(np.pad(b.feats[lo:hi],
                                            pad + ((0, 0),))).to(device),
                    torch.from_numpy(np.pad(b.labels[lo:hi], pad)).to(device),
                    torch.from_numpy(np.pad(b.mask[lo:hi], pad)).to(device),
                    b.qidx[lo:hi]))

    def _candidates(self, W) -> torch.Tensor:
        return torch.as_tensor(np.asarray(W, np.float32), device=self.device)

    def mean_metric(self, W: np.ndarray) -> np.ndarray:
        """``W [F, C]`` candidate weights → ``[C]`` macro-averaged metric
        (f64 sums on the host, as the reference's)."""
        Wd = self._candidates(W)
        total = np.zeros(Wd.shape[1], np.float64)
        with full_f32_products():
            for feats, labels, mask, _ in self.buckets:
                vals = candidate_metrics(self.scorer, feats, labels, mask, Wd)
                total += vals.cpu().numpy().astype(np.float64).sum(axis=0)
        return total / self.n_queries

    def per_query_matrix(self, W: np.ndarray) -> np.ndarray:
        """``W [F, C]`` candidate weights → ``[Q, C]`` per-query metrics
        (Dataset order)."""
        Wd = self._candidates(W)
        out = np.zeros((self.n_queries, Wd.shape[1]), np.float64)
        with full_f32_products():
            for feats, labels, mask, qidx in self.buckets:
                vals = candidate_metrics(self.scorer, feats, labels, mask, Wd)
                out[qidx] = vals[: len(qidx)].cpu().numpy()
        return out


def linear_scores(ds: Dataset, w: np.ndarray, device: torch.device,
                  bias: float = 0.0) -> list:
    """Per-query scores ``feats @ w + bias`` of a linear model, computed
    in f32 on ``device``: ``w`` is cut or zero-padded to the dataset's
    width (a feature the model never saw scores 0)."""
    feats, _, qptr = flatten(ds)
    wf = np.zeros(ds.n_features, np.float32)
    n = min(len(w), ds.n_features)
    wf[:n] = np.asarray(w[:n], np.float64).astype(np.float32)
    with full_f32_products():
        flat = torch.matmul(torch.from_numpy(feats).to(device),
                            torch.from_numpy(wf).to(device))
    if bias:
        flat = flat + np.float32(bias)
    flat = flat.cpu().numpy()
    return [flat[qptr[i]: qptr[i + 1]] for i in range(len(ds.queries))]
