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

A ``-sparse`` CSR dataset under the device budget comes in through
``iter_buckets``' bounded chunks (the same buckets as the dense file's
when a size class fits one chunk); above it the rankers take the COO
layer (``ops.sparse_eval``) instead.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ranklib_tpu_torch.data.dataset import (
    Dataset, flatten_meta, iter_buckets,
)
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


def metrics_of_scores(scorer: MetricScorer, sc: torch.Tensor,
                      labels: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """``sc [B, D, C]`` candidate scores → per-query metric ``[B, C]``,
    the candidates folded into the metric's row axis."""
    B, D, C = sc.shape
    sc = sc.transpose(1, 2).reshape(B * C, D)
    lab = labels[:, None, :].expand(B, C, D).reshape(B * C, D)
    msk = mask[:, None, :].expand(B, C, D).reshape(B * C, D)
    return scorer.score_from_scores(lab, sc, msk).view(B, C)


def candidate_metrics(scorer: MetricScorer, feats: torch.Tensor,
                      labels: torch.Tensor, mask: torch.Tensor,
                      W: torch.Tensor) -> torch.Tensor:
    """``feats [B, D, F]``, ``W [F, C]`` → per-query metric ``[B, C]`` of
    each candidate's scores ``feats @ W``."""
    return metrics_of_scores(scorer, torch.matmul(feats, W), labels, mask)


def device_class_buckets(ds: Dataset, device: torch.device):
    """(feats [B, D, F], labels [B, D], mask [B, D], qidx) on ``device``,
    one a padded size class: the dense pipeline's buckets. A CSR
    dataset's bounded host chunks of a class are joined on the device, so
    the device tensors, and every sum over them, are the dense file's
    whatever the chunk size (generator: the host holds one chunk)."""
    parts = []

    def joined():
        if len(parts) == 1:
            return parts[0]
        return (*(torch.cat([p[i] for p in parts]) for i in range(3)),
                np.concatenate([p[3] for p in parts]))

    for b in iter_buckets(ds, with_feats=True):
        if parts and parts[0][1].shape[1] != b.D:
            yield joined()
            parts = []
        parts.append((*(torch.from_numpy(a).to(device)
                        for a in (b.feats, b.labels, b.mask)), b.qidx))
    if parts:
        yield joined()


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
        for feats, labels, mask, qidx in device_class_buckets(ds, device):
            B, D = labels.shape
            rows = max(1, min(B, _DOC_BUDGET // D))
            for lo in range(0, B, rows):
                hi = min(lo + rows, B)
                pad = rows - (hi - lo)
                self.buckets.append((
                    *(torch.cat([t[lo:hi], t.new_zeros((pad,) + t.shape[1:])])
                      for t in (feats, labels, mask)),
                    qidx[lo:hi]))

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


def materializer(ds: Dataset):
    """``materialize(lo, hi)`` → a fresh ``[hi - lo, F]`` f32 block of the
    dataset's doc rows: a CSR dataset's ``materialize_rows``, a dense
    one's rows sliced from its query blocks (never a copy of the whole
    ``[N, F]``)."""
    if hasattr(ds, "materialize_rows"):
        return ds.materialize_rows
    F = ds.n_features
    qstart = np.zeros(len(ds.queries) + 1, np.int64)
    np.cumsum([q.n for q in ds.queries], out=qstart[1:])

    def materialize(lo, hi):
        out = np.zeros((hi - lo, F), np.float32)
        qi = int(np.searchsorted(qstart, lo, side="right") - 1)
        while qi < len(ds.queries) and qstart[qi] < hi:
            r0, r1 = int(max(qstart[qi], lo)), int(min(qstart[qi + 1], hi))
            q = ds.queries[qi]
            w = min(q.feats.shape[1], F)
            out[r0 - lo: r1 - lo, :w] = (
                q.feats[r0 - qstart[qi]: r1 - qstart[qi], :w])
            qi += 1
        return out
    return materialize


def row_blocks(ds: Dataset):
    """(qptr [Q+1], the dataset's ``[rows, F]`` f32 feature rows in doc
    order, in blocks of ``RANKLIB_TPU_SPARSE_CHUNK_MB``): a generator, one
    block on the host at a time, the same blocks for a CSR dataset and
    its dense file, so that a product over them rounds alike for both."""
    from ranklib_tpu_torch.data.sparse import _chunk_bytes

    N = ds.n_docs
    _, qptr = flatten_meta(ds)
    rows = max(1, _chunk_bytes() // (max(1, ds.n_features) * 4))
    materialize = materializer(ds)
    return qptr, (materialize(lo, min(lo + rows, N))
                  for lo in range(0, N, rows))


def blockwise_scores(ds: Dataset, score_fn, device: torch.device) -> list:
    """Per-query f32 scores of ``score_fn(X [rows, F] on device) → [rows]``
    over :func:`row_blocks`, in full f32."""
    qptr, blocks = row_blocks(ds)
    parts = []
    with full_f32_products():
        for X in blocks:
            parts.append(score_fn(torch.from_numpy(X).to(device))
                         .cpu().numpy())
            del X                        # before the next block exists
    flat = np.concatenate(parts) if parts else np.zeros(0, np.float32)
    return [flat[qptr[i]: qptr[i + 1]] for i in range(len(ds.queries))]


def linear_scores(ds: Dataset, w: np.ndarray, device: torch.device,
                  bias: float = 0.0) -> list:
    """Per-query scores ``feats @ w + bias`` of a linear model, computed
    in f32 on ``device``: ``w`` is cut or zero-padded to the dataset's
    width (a feature the model never saw scores 0)."""
    wf = np.zeros(ds.n_features, np.float32)
    n = min(len(w), ds.n_features)
    wf[:n] = np.asarray(w[:n], np.float64).astype(np.float32)
    wd = torch.from_numpy(wf).to(device)

    def score(X):
        flat = torch.matmul(X, wd)
        return flat + np.float32(bias) if bias else flat
    return blockwise_scores(ds, score, device)
