"""Host-CSR dataset for wide and sparse inputs (``-sparse``; copy of
ranklib_tpu.data.sparse).

The file lands in host CSR (``indptr``/``fids``/``vals``, memory ~ nnz;
ref: learning/SparseDataPoint.java:~15 fid[]/val[] arrays) and dense
blocks are materialized on demand in bounded chunks of
``RANKLIB_TPU_SPARSE_CHUNK_MB`` (256 MB by default). ``-norm`` applies
lazily at materialization (:func:`normalize_csr`), with per-query
statistics stored sparsely, so a materialized block is bit-equal to the
dense pipeline's normalized rows.

In the port the tree rankers use it for ``-sparse -norm``, the
``-tvs``/``-tts`` split grids, ``-kcv`` folds (all binned by
``data.binned.binned_from_csr``) and ``-load -test/-rank -sparse``
(``models.gbdt.eval_ensemble_dataset``'s chunked branch).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ranklib_tpu_torch.data.dataset import Dataset, Query
from ranklib_tpu_torch.data.letor import _desc_pos
from ranklib_tpu_torch.utils.errors import RankLibError
from ranklib_tpu_torch.utils.logging import log


def _chunk_bytes() -> int:
    mb = os.environ.get("RANKLIB_TPU_SPARSE_CHUNK_MB", "256")
    try:
        return max(1, int(mb)) << 20
    except ValueError:
        return 256 << 20


def _row_select(indptr: np.ndarray, sel: np.ndarray) -> np.ndarray:
    """indptr of the stored entries kept by ``sel`` [nnz] bool: a cumsum
    sampled at the row boundaries, O(nnz) with no [nnz] row-id array."""
    cs = np.concatenate([[0], np.cumsum(sel, dtype=np.int64)])
    return cs[indptr]


@dataclass
class CSRDataset(Dataset):
    """A feature-free Dataset plus host CSR storage of the raw values;
    ``queries[i].feats is None``, rows are docs in query file order."""

    indptr: np.ndarray = None    # [N+1] int64 — per-doc pair ranges
    fids: np.ndarray = None      # [nnz] int32, 0-based feature ids
    vals: np.ndarray = None      # [nnz] float32
    qrow: np.ndarray = None      # [Q+1] int64 — query → doc-row range
    # lazy per-query normalization (normalize_csr), stored sparsely: only
    # the features PRESENT in a query carry a statistic (an all-zero
    # column's dense statistics leave its 0s alone under every scheme)
    norm_kind: str | None = None
    ns_indptr: np.ndarray = None  # [Q+1] int64 — per-query stat ranges
    ns_fids: np.ndarray = None    # [S] int32 0-based fids carrying stats
    ns_a: np.ndarray = None       # [S] f32 (μ / Σ|v| / min)
    ns_b: np.ndarray = None       # [S] f32 (σ / unused / range)
    ns_width: int = 0             # feature width the stats were taken at

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def _norm_fields(self, ns_sel: np.ndarray | None = None, **over) -> dict:
        """The normalization fields (``ns_sel``: the statistics kept)."""
        if self.norm_kind is None:
            return {}
        if ns_sel is None:
            kw = dict(ns_indptr=self.ns_indptr, ns_fids=self.ns_fids,
                      ns_a=self.ns_a, ns_b=self.ns_b)
        else:
            kw = dict(ns_indptr=_row_select(self.ns_indptr, ns_sel),
                      ns_fids=self.ns_fids[ns_sel], ns_a=self.ns_a[ns_sel],
                      ns_b=(self.ns_b[ns_sel] if self.ns_b is not None
                            else None))
        kw["ns_width"] = self.ns_width
        kw.update(over)
        return kw

    def _apply_norm(self, out: np.ndarray, lo: int, hi: int) -> np.ndarray:
        """Normalize the dense block [hi-lo, width] of doc rows [lo, hi)
        with each row's query statistics. Columns past the statistics'
        width (added by with_width after normalization) stay 0, as in the
        dense order norm-then-widen."""
        Fn = min(self.ns_width, out.shape[1])
        qi = int(np.searchsorted(self.qrow, lo, side="right") - 1)
        while qi < len(self.queries) and self.qrow[qi] < hi:
            r0 = int(max(self.qrow[qi], lo) - lo)
            r1 = int(min(self.qrow[qi + 1], hi) - lo)
            s, e = int(self.ns_indptr[qi]), int(self.ns_indptr[qi + 1])
            f = self.ns_fids[s:e]
            sel = f < Fn
            f = f[sel]
            a = self.ns_a[s:e][sel]
            block = out[r0:r1]
            if self.norm_kind == "sum":
                pos = a > 0
                block[:, f[pos]] = block[:, f[pos]] / a[pos]
            else:
                # zscore and linear share (v − A) / B for B > 0, else 0
                b = self.ns_b[s:e][sel]
                bp = b > 0
                block[:, f[bp]] = (block[:, f[bp]] - a[bp]) / b[bp]
                block[:, f[~bp]] = 0.0
            qi += 1
        return out

    def materialize_rows(self, lo: int, hi: int,
                         width: int | None = None) -> np.ndarray:
        """Dense [hi-lo, width] block of doc rows [lo, hi). Duplicate fids
        on a line keep the last value, as the dense parser overwrites;
        fids ≥ width are clipped."""
        F = int(width if width is not None else self.n_features)
        out = np.zeros((hi - lo, F), np.float32)
        s, e = int(self.indptr[lo]), int(self.indptr[hi])
        if e > s:
            rows = np.repeat(np.arange(hi - lo),
                             np.diff(self.indptr[lo: hi + 1]))
            f = self.fids[s:e]
            keep = f < F
            out[rows[keep], f[keep]] = self.vals[s:e][keep]
        if self.norm_kind is not None:
            out = self._apply_norm(out, lo, hi)
        return out

    def materialize_query(self, qi: int,
                          width: int | None = None) -> np.ndarray:
        return self.materialize_rows(int(self.qrow[qi]),
                                     int(self.qrow[qi + 1]), width)

    def subset_queries(self, idxs) -> "CSRDataset":
        """The given queries, in the order of ``idxs``."""
        idxs = list(idxs)
        counts = np.diff(self.indptr)
        row_chunks, fid_chunks, val_chunks, queries = [], [], [], []
        ns_f, ns_a, ns_b, ns_counts = [], [], [], []
        for qi in idxs:
            lo, hi = int(self.qrow[qi]), int(self.qrow[qi + 1])
            row_chunks.append(counts[lo:hi])
            s, e = int(self.indptr[lo]), int(self.indptr[hi])
            fid_chunks.append(self.fids[s:e])
            val_chunks.append(self.vals[s:e])
            queries.append(self.queries[qi])
            if self.norm_kind is not None:
                u, v = int(self.ns_indptr[qi]), int(self.ns_indptr[qi + 1])
                ns_f.append(self.ns_fids[u:v])
                ns_a.append(self.ns_a[u:v])
                if self.ns_b is not None:
                    ns_b.append(self.ns_b[u:v])
                ns_counts.append(v - u)
        new_counts = (np.concatenate(row_chunks) if row_chunks
                      else np.zeros(0, np.int64))
        indptr = np.zeros(len(new_counts) + 1, np.int64)
        np.cumsum(new_counts, out=indptr[1:])
        qrow = np.zeros(len(idxs) + 1, np.int64)
        np.cumsum([q.n for q in queries], out=qrow[1:])
        kw = {}
        if self.norm_kind is not None:
            ns_indptr = np.zeros(len(idxs) + 1, np.int64)
            np.cumsum(ns_counts, out=ns_indptr[1:])
            kw = dict(
                ns_indptr=ns_indptr,
                ns_fids=(np.concatenate(ns_f) if ns_f
                         else np.zeros(0, np.int32)),
                ns_a=(np.concatenate(ns_a) if ns_a
                      else np.zeros(0, np.float32)),
                ns_b=np.concatenate(ns_b) if ns_b else None,
                ns_width=self.ns_width)
        return CSRDataset(
            queries=queries, n_features=self.n_features, indptr=indptr,
            fids=(np.concatenate(fid_chunks) if fid_chunks
                  else np.zeros(0, np.int32)),
            vals=(np.concatenate(val_chunks) if val_chunks
                  else np.zeros(0, np.float32)),
            qrow=qrow, norm_kind=self.norm_kind, **kw)

    def subset_features(self, fids) -> "CSRDataset":
        """Keep the listed features (``-feature``); the others read 0."""
        from ranklib_tpu_torch.data.dataset import feature_mask_from_fids

        keep = feature_mask_from_fids(fids, self.n_features)
        # stored fids can exceed n_features after a narrowing with_width
        inw = self.fids < self.n_features
        sel = keep[np.minimum(self.fids, self.n_features - 1)] & inw
        ns_sel = None
        if self.norm_kind is not None:
            # a subset after normalization drops the removed columns'
            # statistics too (their materialized 0s stay 0, as dense)
            keep_n = np.zeros(max(self.ns_width, len(keep)), bool)
            keep_n[: len(keep)] = keep
            ns_sel = keep_n[self.ns_fids]
        return CSRDataset(
            queries=self.queries, n_features=self.n_features,
            indptr=_row_select(self.indptr, sel), fids=self.fids[sel],
            vals=self.vals[sel], qrow=self.qrow, norm_kind=self.norm_kind,
            **self._norm_fields(ns_sel))

    def with_width(self, n_features: int) -> "CSRDataset":
        """Width change with the dense pipeline's destructive clip:
        widening is metadata (implicit columns read 0); narrowing drops
        the stored entries with fid ≥ width, so a later widening cannot
        bring them back."""
        if n_features == self.n_features:
            return self
        if n_features < self.n_features:
            sel = self.fids < n_features
            ns_sel = (self.ns_fids < n_features
                      if self.norm_kind is not None else None)
            return CSRDataset(
                queries=self.queries, n_features=n_features,
                indptr=_row_select(self.indptr, sel), fids=self.fids[sel],
                vals=self.vals[sel], qrow=self.qrow,
                norm_kind=self.norm_kind,
                **self._norm_fields(ns_sel, ns_width=min(self.ns_width,
                                                         n_features)))
        return CSRDataset(queries=self.queries, n_features=n_features,
                          indptr=self.indptr, fids=self.fids,
                          vals=self.vals, qrow=self.qrow,
                          norm_kind=self.norm_kind, **self._norm_fields())


def _py_parse_csr(path: str):
    """Python parser with the outputs of ``native_parse_letor_csr`` (no
    g++, oversized tokens, malformed input's precise message)."""
    import gzip

    labels, counts, qids = [], [], []
    fid_chunks, val_chunks, starts = [], [], []
    prev_qid = None
    max_fid = 0
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        for ln, line in enumerate(fh, 1):
            hp = _desc_pos(line)         # token-boundary '#' (native rule)
            body = (line[:hp] if hp >= 0 else line).strip()
            if not body:
                continue
            toks = body.split()
            if len(toks) < 2 or not toks[1].startswith("qid:"):
                raise RankLibError(f"{path}:{ln}: malformed line")
            try:
                label = float(toks[0])
            except ValueError:
                raise RankLibError(f"{path}:{ln}: bad label {toks[0]!r}")
            if label < 0:
                raise RankLibError(f"{path}:{ln}: negative label")
            qid = toks[1][4:]
            row_f, row_v = [], []
            for tok in toks[2:]:
                fid_s, _, val_s = tok.partition(":")
                try:
                    fid = int(fid_s)
                    val = float(val_s)
                except ValueError:
                    raise RankLibError(f"{path}:{ln}: bad pair {tok!r}")
                if fid <= 0:
                    raise RankLibError(f"{path}:{ln}: fid must be >= 1")
                row_f.append(fid - 1)
                row_v.append(val)
                max_fid = max(max_fid, fid)
            labels.append(label)
            counts.append(len(row_f))
            fid_chunks.append(row_f)
            val_chunks.append(row_v)
            if qid != prev_qid:
                qids.append(qid)
                starts.append(len(labels) - 1)
                prev_qid = qid
    if not labels:
        raise RankLibError(f"No queries read from {path}")
    qptr = np.asarray(starts + [len(labels)], np.int64)
    counts = np.asarray(counts, np.int32)
    indptr = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    fids = np.asarray([f for row in fid_chunks for f in row], np.int32)
    vals = np.asarray([v for row in val_chunks for v in row], np.float32)
    return (np.asarray(labels, np.float32), qptr, qids, indptr, fids, vals,
            counts, max_fid)


def _parse_csr(path: str, want_descs: bool):
    """(parsed CSR arrays, descs or None) of a plain file: native first,
    the Python parser when it is unavailable or refuses the file."""
    from ranklib_tpu_torch.data.letor import read_descs
    from ranklib_tpu_torch.native.loader import (
        NativeParseError, native_parse_letor_csr,
    )

    try:
        parsed = native_parse_letor_csr(path)
    except NativeParseError:
        parsed = None
    if parsed is None:
        parsed = _py_parse_csr(path)
    descs = read_descs(path, int(parsed[1][-1])) if want_descs else None
    return parsed, descs


def read_letor_sparse(path: str, must_have_rel_doc: bool = False,
                      n_features: int | None = None,
                      missing_zero: bool = True,
                      quiet: bool = False,
                      want_descs: bool = False) -> CSRDataset:
    """Read a LETOR file into a :class:`CSRDataset` (native parser when
    available, Python otherwise; gzip through a streamed temporary copy).
    ``want_descs`` also attaches the per-doc '#' descriptions, which
    ``-qrel`` (docid matching) and ``-indri`` (docid output) need."""
    from ranklib_tpu_torch.native.loader import gunzip_to_temp

    if path.endswith(".gz"):
        tmp_path = gunzip_to_temp(path)
        try:
            parsed, descs = _parse_csr(tmp_path, want_descs)
        finally:
            try:
                os.unlink(tmp_path)
            except OSError:
                pass
    else:
        parsed, descs = _parse_csr(path, want_descs)
    labels, qptr, qids, indptr, fids, vals, counts, max_fid = parsed

    if not missing_zero:
        from ranklib_tpu_torch.data.letor import _check_fully_specified
        _check_fully_specified(path, counts, max_fid, qptr, qids)

    F = max(int(max_fid), int(n_features or 0))
    queries = [Query(qid=qid, labels=labels[qptr[i]:qptr[i + 1]],
                     feats=None,
                     descs=(descs[qptr[i]:qptr[i + 1]] if descs is not None
                            else []))
               for i, qid in enumerate(qids)]
    ds = CSRDataset(queries=queries, n_features=F, indptr=indptr, fids=fids,
                    vals=vals, qrow=np.asarray(qptr, np.int64))
    if must_have_rel_doc:
        keep = [i for i, q in enumerate(ds.queries) if (q.labels > 0).any()]
        if not keep:
            raise RankLibError(f"No queries with a relevant doc in {path}")
        if len(keep) < len(ds.queries):
            if not quiet:
                log(f"[-sparse] dropped {len(ds.queries) - len(keep)} "
                    f"queries with no relevant doc")
            ds = ds.subset_queries(keep)
    if not quiet:
        dense_mb = ds.n_docs * F * 4 / (1 << 20)
        csr_mb = (ds.nnz * 8 + ds.n_docs * 8) / (1 << 20)
        log(f"(CSR: {len(ds.queries)} ranked lists, {ds.n_docs} entries, "
            f"{ds.nnz} stored values — {csr_mb:.0f} MB vs "
            f"{dense_mb:.0f} MB dense)")
    return ds


def normalize_csr(ds: CSRDataset, name: str) -> CSRDataset:
    """Per-query normalization of a CSRDataset, applied lazily: the
    statistics are computed here, one query materialized at a time (the
    dense pipeline's numpy reductions over the same arrays, so the floats
    are bit-equal), and :meth:`CSRDataset.materialize_rows` applies the
    dense formula elementwise. Statistics are stored only for the features
    present in a query, so their memory is ~nnz."""
    from ranklib_tpu_torch.data.normalize import get_normalizer

    get_normalizer(name)                     # validate the name
    if ds.norm_kind is not None:
        raise RankLibError("dataset is already normalized")
    kind = name.lower()
    Q, F = len(ds.queries), ds.n_features
    ns_counts = np.zeros(Q, np.int64)
    f_chunks, a_chunks, b_chunks = [], [], []
    for qi in range(Q):
        feats = ds.materialize_query(qi)
        if kind == "sum":
            arow = np.abs(feats).sum(axis=0)
            brow = None
        elif kind == "zscore":
            arow = feats.mean(axis=0)
            brow = feats.std(axis=0)         # population σ, like the dense
        else:                                # linear
            arow = feats.min(axis=0)
            brow = feats.max(axis=0) - arow
        s, e = (int(ds.indptr[ds.qrow[qi]]),
                int(ds.indptr[ds.qrow[qi + 1]]))
        f = np.unique(ds.fids[s:e])
        f = f[f < F].astype(np.int32)
        ns_counts[qi] = len(f)
        f_chunks.append(f)
        a_chunks.append(arow[f].astype(np.float32))
        if brow is not None:
            b_chunks.append(brow[f].astype(np.float32))
    ns_indptr = np.zeros(Q + 1, np.int64)
    np.cumsum(ns_counts, out=ns_indptr[1:])
    return CSRDataset(
        queries=ds.queries, n_features=F, indptr=ds.indptr,
        fids=ds.fids, vals=ds.vals, qrow=ds.qrow, norm_kind=kind,
        ns_indptr=ns_indptr,
        ns_fids=(np.concatenate(f_chunks) if f_chunks
                 else np.zeros(0, np.int32)),
        ns_a=(np.concatenate(a_chunks) if a_chunks
              else np.zeros(0, np.float32)),
        ns_b=np.concatenate(b_chunks) if b_chunks else None,
        ns_width=F)
