"""The COO score layer for wide ``-sparse`` data (ranklib_tpu.ops.sparse_eval).

The dense candidate evaluator (``ops.batched_eval``) holds every padded
``[rows, D, F]`` feature block on the device. Above a device budget
(:func:`device_dense_budget_bytes`) Coordinate Ascent, AdaRank and the
neural rankers keep the dataset on the device as COO instead — ``fids``,
``vals`` and ascending doc rows, memory ~ stored values — and score
candidate weight matrices as

    scores[n, k] = Σ_{j : row[j] = n} vals[j] · W[fids[j], k]

a gather of ``W`` rows by fid, then a sum over each doc's contiguous run
of entries. The entries come in chunks of at most ``NNZ_CHUNK``, which
bound the ``[chunk, K]`` gather temporary; a doc whose run spans two
chunks adds its two partial sums into the flat score table.

The sum is deterministic on the card: ``torch.segment_reduce`` adds each
run in order (one thread a run and column), and the per-chunk partials
land with ``index_add_`` on distinct rows, one add each — a float
``index_add_`` over repeated rows would add in atomic order, and two
equal fits could pick different coordinates on a near-tie.

The COO is taken from materialized row chunks
(``CSRDataset.materialize_rows``), so lazy ``-norm``, width clipping and
a line's last duplicate fid are the dense pipeline's. ``zscore`` and
``linear`` make a query's implicit zeros nonzero, so the COO then holds
every (doc, feature present in its query) pair. Sums run over a doc's
nonzeros, not over all F columns, so the layer agrees with the dense
product to f32 rounding, not bit for bit.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ranklib_tpu_torch.metrics.base import MetricScorer

# stored values a device chunk: bounds the [CHUNK, K] gather temporary
# (136 MB f32 at K = 260, Coordinate Ascent's 5 restarts x 52 candidates)
NNZ_CHUNK = 1 << 17


def device_dense_budget_bytes() -> int:
    """The device budget for dense bucket residency
    (``RANKLIB_TPU_DEVICE_DENSE_MB``, 1024 by default, the reference's;
    0 forces the COO layer)."""
    mb = os.environ.get("RANKLIB_TPU_DEVICE_DENSE_MB", "1024")
    try:
        return max(0, int(mb)) << 20
    except ValueError:
        return 1024 << 20


def wants_sparse_eval(ds) -> bool:
    """True for a CSR dataset whose dense ``[N, F]`` f32 would exceed the
    budget: the route switch of the rankers that have a COO branch."""
    return (bool(ds.queries) and ds.queries[0].feats is None
            and hasattr(ds, "materialize_rows")
            and ds.n_docs * ds.n_features * 4 > device_dense_budget_bytes())


def coo_chunk_size(nnz_max: int) -> int:
    """Entries a chunk: the next power of two ≥ ``nnz_max`` from 4,096,
    capped at ``NNZ_CHUNK``."""
    chunk = 1 << 12
    while chunk < nnz_max and chunk < NNZ_CHUNK:
        chunk <<= 1
    return chunk


def coo_entries(ds):
    """(fids, vals, rows) of every nonzero of ``ds`` in doc-row order
    (int64, f32, int64), from its materialized row blocks
    (``batched_eval.row_blocks``: CSR, or a dense dataset such as a narrow
    validation file beside a wide CSR training file)."""
    from ranklib_tpu_torch.ops.batched_eval import row_blocks

    f_parts, v_parts, r_parts = [], [], []
    lo = 0
    for X in row_blocks(ds)[1]:
        r, f = np.nonzero(X)
        f_parts.append(f.astype(np.int64))
        v_parts.append(X[r, f].astype(np.float32))
        r_parts.append((r + lo).astype(np.int64))
        lo += X.shape[0]
        del X                            # before the next block exists
    cat = (lambda parts, dt: np.concatenate(parts) if parts
           else np.zeros(0, dt))
    return (cat(f_parts, np.int64), cat(v_parts, np.float32),
            cat(r_parts, np.int64))


def coo_chunks(fids, vals, rows, device) -> list:
    """Device chunks ``(fids, vals, row_ids, run_lengths)`` of ≤
    ``coo_chunk_size`` entries: ``row_ids`` the distinct rows of a chunk,
    ascending, ``run_lengths`` their runs of entries."""
    chunk = coo_chunk_size(len(fids))
    out = []
    for s in range(0, len(fids), chunk):
        rid, run = np.unique(rows[s: s + chunk], return_counts=True)
        out.append(tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                         for a in (fids[s: s + chunk], vals[s: s + chunk],
                                   rid.astype(np.int64),
                                   run.astype(np.int64))))
    return out


def build_sparse_data(ds, device: torch.device, with_qidx: bool = False):
    """(chunks, buckets, N) of ``ds`` on ``device``: the COO chunks of
    :func:`coo_chunks` and the metric buckets ``(labels, mask, didx)`` of
    ``gbdt.boost._host_buckets`` (pad slots → the zero row N; with
    ``with_qidx`` also each row's query index, pads → Q)."""
    from ranklib_tpu_torch.gbdt.boost import _host_buckets, _upload

    N = ds.n_docs
    chunks = coo_chunks(*coo_entries(ds), device)
    buckets = _upload(_host_buckets(
        ds, N, qidx_sentinel=len(ds.queries) if with_qidx else None), device)
    return chunks, buckets, N


def segment_rows(part: torch.Tensor, rid: torch.Tensor, run: torch.Tensor,
                 out: torch.Tensor) -> torch.Tensor:
    """``out[rid[i]] += Σ`` of the i-th run of ``part``'s rows, in order
    (``part`` [C, K]; the runs tile it). Deterministic on every device."""
    seg = torch.segment_reduce(part, "sum", lengths=run, axis=0,
                               unsafe=True)
    return out.index_add_(0, rid, seg)


def sparse_scores_flat(Wf: torch.Tensor, chunks, N: int) -> torch.Tensor:
    """``Wf [F, K]`` → flat scores ``[N + 1, K]`` (row N, the pads', is 0)."""
    S = torch.zeros((N + 1, Wf.shape[1]), dtype=torch.float32,
                    device=Wf.device)
    for fids, vals, rid, run in chunks:
        segment_rows(Wf.index_select(0, fids) * vals[:, None], rid, run, S)
    return S


def sparse_mean_metric(scorer: MetricScorer, Wf: torch.Tensor, chunks,
                       buckets, N: int, n_queries: int,
                       group=None) -> torch.Tensor:
    """``Wf [F, K]`` → ``[K]`` mean metric over all queries (f32, on the
    device; nothing is read back). ``group``: a ``-dp`` rank's process
    group, across which the totals are summed (``n_queries`` global)."""
    from ranklib_tpu_torch.gbdt.grow import sum_across
    from ranklib_tpu_torch.ops.batched_eval import metrics_of_scores

    S = sparse_scores_flat(Wf, chunks, N)
    total = torch.zeros(Wf.shape[1], dtype=torch.float32, device=Wf.device)
    for lab, msk, didx in (b[:3] for b in buckets):
        total += metrics_of_scores(scorer, S[didx], lab, msk).sum(dim=0)
    return sum_across(total, group) / n_queries


def adarank_weak_matrix(ds, scorer: MetricScorer, device: torch.device,
                        queries=None) -> np.ndarray:
    """AdaRank's weak-metric matrix ``S[q, f]``, the metric of query q
    ranked by feature f alone, as a dense ``[Q, F]`` f32, built sparsely: a
    feature absent from a query scores all its documents 0, whose stable
    ranking is the file order, so ``S[q, f]`` is the query's zero-score
    metric m0(q) there; only the present (query, feature) pairs are
    scored, a padded size class at a time in blocks of ≤ 2^26 scores.
    No ``[N, F]`` block and no ``[F, F]`` candidate matrix; ``S`` itself
    (Q·F) is AdaRank's remaining ceiling. ``queries``: the rows of these
    query indices only, in their order (a ``-dp`` rank's own)."""
    from ranklib_tpu_torch.data.dataset import padded_size
    from ranklib_tpu_torch.ops.batched_eval import (
        full_f32_products, metrics_of_scores,
    )

    F = ds.n_features
    queries = list(range(len(ds.queries)) if queries is None else queries)
    Q = len(queries)
    present = []
    for qi in queries:
        s = int(ds.indptr[ds.qrow[qi]])
        e = int(ds.indptr[ds.qrow[qi + 1]])
        f = np.unique(ds.fids[s:e])
        present.append(f[f < F].astype(np.int64))
    S = np.empty((Q, F), np.float32)
    groups = {}
    for j, qi in enumerate(queries):
        groups.setdefault(padded_size(ds.queries[qi].n), []).append(j)

    def metric(idxs, D, sc):
        labs = np.zeros((len(idxs), D), np.float32)
        msk = np.zeros((len(idxs), D), bool)
        for b, j in enumerate(idxs):
            q = ds.queries[queries[j]]
            labs[b, : q.n] = q.labels
            msk[b, : q.n] = True
        with full_f32_products():
            return metrics_of_scores(
                scorer, torch.from_numpy(sc).to(device),
                torch.from_numpy(labs).to(device),
                torch.from_numpy(msk).to(device)).cpu().numpy()

    budget = 1 << 26
    for D, idxs in sorted(groups.items()):
        S[idxs, :] = metric(idxs, D, np.zeros((len(idxs), D, 1),
                                              np.float32))
        cmax = max(len(present[j]) for j in idxs)
        if cmax == 0:
            continue
        rows = min(len(idxs), max(1, budget // (D * cmax)))
        for lo in range(0, len(idxs), rows):
            sub = [j for j in idxs[lo: lo + rows] if len(present[j])]
            if not sub:
                continue
            c = max(len(present[j]) for j in sub)
            sc = np.zeros((len(sub), D, c), np.float32)
            for b, j in enumerate(sub):
                fq = present[j]
                sc[b, : ds.queries[queries[j]].n, : len(fq)] = \
                    ds.materialize_query(queries[j])[:, fq]
            vals = metric(sub, D, sc)
            for b, j in enumerate(sub):
                S[j, present[j]] = vals[b, : len(present[j])]
    return S
