"""Streamed parse→bin loader for wide and sparse inputs (``-sparse``; copy
of ranklib_tpu.data.binned).

The dense pipeline (``data.letor`` → ``gbdt.binning``) holds the whole
``[N, F]`` f32 feature matrix before it bins; for wide sparse files that
is the host-memory wall (the reference serves them with sparse vectors,
ref: learning/SparseDataPoint.java:~15). This loader never holds raw
values:

  pass 1  ``letor_stat``        — doc and query counts, max fid;
  pass 2  ``letor_value_stats`` — per-feature capped unique sets and
                                  min/max off the file, implicit zeros of
                                  unspecified fids folded in; then
                                  ``thresholds_from_uniques``, the dense
                                  pipeline's decision code, so the grids
                                  are bit-identical;
  pass 3  ``letor_fill_binned`` — parse and bin in one stream into the
                                  int16 bin matrix the trees train on.

Host peak is the 2-byte bin matrix. The tree rankers train on it
bit-identically to the dense path. :func:`binned_from_csr` bins a
:class:`~ranklib_tpu_torch.data.sparse.CSRDataset` in bounded dense chunks
(``-sparse -norm``, the ``-tvs``/``-tts`` split grids and ``-kcv`` folds).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ranklib_tpu_torch.data.dataset import Dataset, Query
from ranklib_tpu_torch.utils.errors import RankLibError
from ranklib_tpu_torch.utils.logging import log


@dataclass
class BinnedDataset(Dataset):
    """A feature-free Dataset plus its doc-major bin matrix.

    ``queries[i].feats is None``; the training representation is
    ``binned [N, F] int16`` in query file order with ``thresholds [F, B]``
    (value ≤ thresholds[f, b] ⟺ bin ≤ b). Metrics and lambdas need only
    labels and masks; the tree rankers consume ``binned`` directly.
    """

    thresholds: np.ndarray = None   # [F, B] float32, +inf padded
    binned: np.ndarray = None       # [N, F] int16, query file order


def read_letor_binned(path: str, n_threshold: int = 256,
                      thresholds: np.ndarray | None = None,
                      must_have_rel_doc: bool = False,
                      n_features: int | None = None,
                      missing_zero: bool = True,
                      quiet: bool = False,
                      want_descs: bool = False) -> BinnedDataset:
    """Stream a LETOR file into a :class:`BinnedDataset`.

    ``thresholds``: bin with an existing grid (validation and test files
    bin with the training grid, as in the dense pipeline); otherwise the
    grid comes from this file's streamed value statistics, bit-identical
    to ``compute_thresholds`` on the dense matrix. ``want_descs`` streams
    the per-doc '#' descriptions too (one more pass) for ``-qrel`` and
    ``-indri``.

    Raises :class:`RankLibError` when the native parser is unavailable or
    the file needs the Python parser (oversized tokens); callers fall back
    to the dense pipeline.
    """
    from ranklib_tpu_torch.gbdt.binning import thresholds_from_uniques
    from ranklib_tpu_torch.native.loader import (
        NativeParseError, gunzip_to_temp, native_letor_stat,
        native_letor_value_stats, native_parse_letor_binned,
    )

    if path.endswith(".gz"):
        # the three native passes read a streamed temporary copy
        tmp_path = gunzip_to_temp(path)
        try:
            return read_letor_binned(
                tmp_path, n_threshold=n_threshold, thresholds=thresholds,
                must_have_rel_doc=must_have_rel_doc, n_features=n_features,
                missing_zero=missing_zero, quiet=quiet,
                want_descs=want_descs)
        finally:
            try:
                os.unlink(tmp_path)
            except OSError:
                pass
    try:
        stat = native_letor_stat(path)
    except NativeParseError as e:
        raise RankLibError(str(e)) from None
    if stat is None:
        raise RankLibError(
            "streaming -sparse loader requires the native parser "
            "(g++ unavailable?); use the dense pipeline")
    n_docs, n_queries, max_fid = stat
    if n_docs == 0 or n_queries == 0:
        raise RankLibError(f"No queries read from {path}")
    F = max(max_fid, int(n_features or 0))
    grid_local = thresholds is None
    try:
        if thresholds is None:
            if n_threshold > 400:
                raise RankLibError(
                    f"-sparse streaming supports -tc up to 400 "
                    f"(got {n_threshold}); use the dense pipeline")
            stats = native_letor_value_stats(path, F, n_threshold)
            if stats is None:
                raise RankLibError(
                    "native streaming stats unavailable; use the dense "
                    "pipeline")
            thresholds, _ = thresholds_from_uniques(*stats, n_threshold)
        elif thresholds.shape[0] != F:
            # the training grid defines the feature space: fids above it
            # are unusable by the model (clipped), missing ones read 0
            F = thresholds.shape[0]
        parsed = native_parse_letor_binned(path, thresholds, n_docs,
                                           n_queries)
        if parsed is None:
            raise RankLibError(
                "native streaming binner unavailable; use the dense "
                "pipeline")
        labels, bins, qptr, qids, counts_per_doc = parsed
    except NativeParseError as e:
        raise RankLibError(str(e)) from None
    if not missing_zero:
        from ranklib_tpu_torch.data.letor import _check_fully_specified
        _check_fully_specified(path, counts_per_doc, max_fid, qptr, qids)
    descs = None
    if want_descs:
        from ranklib_tpu_torch.data.letor import read_descs
        descs = read_descs(path, n_docs)

    queries = []
    keep_rows = np.ones(n_docs, bool) if must_have_rel_doc else None
    n_dropped = 0
    for i, qid in enumerate(qids):
        s, e = int(qptr[i]), int(qptr[i + 1])
        lab = labels[s:e]
        if must_have_rel_doc and not (lab > 0).any():
            keep_rows[s:e] = False
            n_dropped += 1
            continue
        queries.append(Query(qid=qid, labels=lab, feats=None,
                             descs=(descs[s:e] if descs is not None
                                    else [])))
    if not queries:
        raise RankLibError(f"No queries read from {path}")
    if n_dropped:
        if grid_local:
            # the grid above saw every row, but the dense pipeline drops
            # queries without a relevant doc BEFORE its grid: a value only
            # a dropped query holds would change the grid
            raise RankLibError(
                f"{n_dropped} no-relevant-doc queries would be dropped "
                f"after the file-level grid; use the dense pipeline")
        bins = bins[keep_rows]
    if not quiet:
        log(f"Reading feature file [{path}]... [Done.] (streamed to bins)")
        log(f"({len(queries)} ranked lists, "
            f"{sum(q.n for q in queries)} entries read)")
        if n_dropped:
            log(f"({n_dropped} queries with no relevant documents dropped)")
    return BinnedDataset(queries=queries, n_features=F,
                         thresholds=thresholds, binned=bins)


def _chunk_uniques(X: np.ndarray, n_threshold: int):
    """One dense chunk's capped uniques: (per-feature value arrays, counts
    [F], minmax [F, 2] over non-NaN values, ±inf when a feature has none)
    — native when available, np.unique otherwise."""
    from ranklib_tpu_torch.native.loader import native_feature_uniques

    F = X.shape[1]
    nat = native_feature_uniques(X, n_threshold)
    if nat is None:
        cvals, cc = [], []
        cminmax = np.zeros((F, 2), np.float32)
        for f in range(F):
            u = np.unique(X[:, f])
            cvals.append(u[: n_threshold + 1])
            cc.append(len(u))
            fin = u[~np.isnan(u)]
            cminmax[f] = (fin[0], fin[-1]) if len(fin) else (np.inf, -np.inf)
        return cvals, np.asarray(cc), cminmax
    v, ccounts, cminmax = nat
    cvals = [v[f][: min(int(ccounts[f]), n_threshold)] for f in range(F)]
    # the native pass reports (0, 0) for a feature with no non-NaN value;
    # in a merge across chunks that would be a real 0, so restore the
    # inert ±inf seeds (an all-NaN feature is one NaN unique)
    nan_only = (ccounts == 1) & np.isnan(v[:, 0])
    cminmax[nan_only, 0] = np.inf
    cminmax[nan_only, 1] = -np.inf
    return cvals, ccounts, cminmax


def binned_from_csr(ds, n_threshold: int = 256,
                    thresholds: np.ndarray | None = None) -> BinnedDataset:
    """BinnedDataset from a CSRDataset through bounded dense chunks — the
    tree rankers' route for ``-sparse -norm``: the CSR carries lazy
    per-query normalization (``data.sparse.normalize_csr``), so chunks
    materialize normalized and bin as the dense normalize-then-bin does.
    Host peak: one chunk plus the int16 bin matrix.

    The grid merges the chunks' capped-unique statistics exactly: a chunk
    over the cap puts the union over it (the evenly spaced min/max grid,
    as ``compute_thresholds``), otherwise the union of the chunks' uniques
    is the feature's unique set — grids bit-identical to
    ``compute_thresholds`` on the materialized matrix.
    """
    from ranklib_tpu_torch.data.sparse import _chunk_bytes
    from ranklib_tpu_torch.gbdt.binning import (
        bin_features, thresholds_from_uniques,
    )

    N, F = ds.n_docs, ds.n_features
    rows = max(1, _chunk_bytes() // (max(1, F) * 4))
    if thresholds is None:
        uvals = [np.zeros(0, np.float32) for _ in range(F)]
        over = np.zeros(F, bool)
        minmax = np.empty((F, 2), np.float32)
        minmax[:, 0], minmax[:, 1] = np.inf, -np.inf
        for lo in range(0, N, rows):
            cvals, ccounts, cminmax = _chunk_uniques(
                ds.materialize_rows(lo, min(lo + rows, N)), n_threshold)
            for f in range(F):
                if ccounts[f] > n_threshold:
                    over[f] = True
                elif not over[f]:
                    uvals[f] = np.unique(np.concatenate([uvals[f],
                                                         cvals[f]]))
                    if len(uvals[f]) > n_threshold:
                        over[f] = True
            minmax[:, 0] = np.minimum(minmax[:, 0], cminmax[:, 0])
            minmax[:, 1] = np.maximum(minmax[:, 1], cminmax[:, 1])
        # no non-NaN value ever seen: the canonical (0, 0)
        minmax[minmax[:, 0] > minmax[:, 1]] = 0.0
        counts = np.asarray([n_threshold + 1 if over[f] else len(uvals[f])
                             for f in range(F)])
        thresholds, _ = thresholds_from_uniques(uvals, counts, minmax,
                                                n_threshold)
    binned = np.empty((N, F), np.int16)
    for lo in range(0, N, rows):
        hi = min(lo + rows, N)
        binned[lo:hi] = bin_features(ds.materialize_rows(lo, hi),
                                     thresholds).astype(np.int16)
    return BinnedDataset(
        queries=[Query(qid=q.qid, labels=q.labels, feats=None,
                       descs=q.descs) for q in ds.queries],
        n_features=F, thresholds=thresholds, binned=binned)
