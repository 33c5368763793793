"""``-dp`` for the rankers that are not trees (ranklib_tpu.parallel.dp):
Coordinate Ascent, RankBoost, AdaRank, RankNet, LambdaRank and ListNet.

Their per-round statistics are all sums over queries, so a rank holds a
shard of the queries and sums its part across the ranks with
``gbdt.grow.sum_across`` (the reference's ``psum``); every decision taken
from the sums (a coordinate's candidate, a weak ranker, α, a stop) is then
the same on every rank. The queries are dealt as the tree rankers deal
them (``gbdt.boost_dist._shard_queries``: round robin within each padded
size class, smallest class first). A rank may hold no query of the
training or of the validation set: it takes part in every sum with
zeros, so whether a rank calls a collective never depends on its shard.

* :func:`shard_feat_buckets` gives a rank its dense feature buckets, and
  :func:`shard_sparse_data` its COO triple and metric buckets (the
  layout of ``ops.sparse_eval.build_sparse_data``). Each size class holds
  the same row count on every rank, the largest, and the rows past a
  rank's own queries have all-False masks, so the neural rankers' ranks
  can step their r-th query of a class together.
* A rank's query slots are its position in its list of queries
  (``per_dev``): AdaRank keeps its per-query weights P and its rows of
  the weak-metric matrix S in that order.
* The parent does not pickle the data to each rank: :func:`share` puts a
  dataset's arrays (dense: the flat f32 features; ``-sparse``: the CSR
  arrays) in shared memory beside its labels and query metadata, and each
  rank :func:`opens <SharedData.open>` a view of them and builds its own
  shard on its own device.
* :class:`ShardJob` is one ranker's part of a fit as every rank runs it
  (a ranker's ``dp_job``), and :func:`run_jobs` runs several in one
  spawned mesh: :func:`fit_many` is ``parallel.dist.run`` around them (a
  ranker's ``fit(mesh=...)`` is ``fit_many`` of its one fit), and
  :func:`take_rank0` takes each result, rank 0's model (its
  ``MODEL_FIELDS``), once every rank's was found equal.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np
import torch

from ranklib_tpu_torch.data.dataset import (
    Dataset, Query, flatten_meta, padded_size, query_feats,
)
from ranklib_tpu_torch.gbdt.boost import _PAIR_BUDGET
from ranklib_tpu_torch.gbdt.boost_dist import _shard_queries
from ranklib_tpu_torch.utils.errors import RankLibError


def deal(ds: Dataset, n_dev: int):
    """(per_dev, class_rows): each rank's ``[(D, qi), ...]`` in
    :func:`_shard_queries` order, and each padded size class's row count
    on every rank (ref ``_shard_queries``, boost_dist.py:53)."""
    per_dev = [[(padded_size(ds.queries[qi].n), qi) for qi in lst]
               for lst in _shard_queries(ds, n_dev)]
    class_rows = {}
    for lst in per_dev:
        count = {}
        for D, _ in lst:
            count[D] = count.get(D, 0) + 1
        for D, c in count.items():
            class_rows[D] = max(class_rows.get(D, 0), c)
    return per_dev, class_rows


def shard_feat_buckets(ds: Dataset, n_dev: int, rank: int, device,
                       want_qidx: bool = False,
                       doc_budget: int | None = None):
    """Rank ``rank``'s dense buckets (ref ``shard_feat_buckets``, dp.py:50):
    ``(chunks, Qpad, per_dev)``. A chunk is ``(feats [rows, D, F], labels
    [rows, D], mask [rows, D][, qidx [rows] int64])`` on ``device``, one a
    size class or, under ``doc_budget`` (padded documents a chunk), as
    many as it takes, the last padded to the same rows. ``qidx`` is a
    row's query slot on this rank, ``Qpad`` (the largest rank's query
    count) on padded rows."""
    per_dev, class_rows = deal(ds, n_dev)
    Qpad = max((len(lst) for lst in per_dev), default=0)
    F = ds.n_features
    mine = per_dev[rank]
    chunks = []
    for D in sorted(class_rows):
        rows = class_rows[D]
        feats = np.zeros((rows, D, F), np.float32)
        labels = np.zeros((rows, D), np.float32)
        mask = np.zeros((rows, D), bool)
        qidx = np.full(rows, Qpad, np.int64)
        r = 0
        for j, (Dq, qi) in enumerate(mine):
            if Dq != D:
                continue
            q = ds.queries[qi]
            feats[r, : q.n] = query_feats(ds, qi)
            labels[r, : q.n] = q.labels
            mask[r, : q.n] = True
            qidx[r] = j
            r += 1
        step = rows if doc_budget is None else max(1, min(rows,
                                                         doc_budget // D))
        for lo in range(0, rows, step):
            hi = min(lo + step, rows)
            pad = step - (hi - lo)

            def cut(a, fill):
                return torch.from_numpy(np.pad(
                    a[lo:hi], ((0, pad),) + ((0, 0),) * (a.ndim - 1),
                    constant_values=fill)).to(device)

            c = (cut(feats, 0), cut(labels, 0), cut(mask, False))
            if want_qidx:
                c += (cut(qidx, Qpad),)
            chunks.append(c)
    return chunks, Qpad, per_dev


def shard_sparse_data(ds, n_dev: int, rank: int, device,
                      want_qidx: bool = True):
    """Rank ``rank``'s COO score layer and metric buckets (ref
    ``shard_sparse_data``, dp.py:115), laid out as
    ``ops.sparse_eval.build_sparse_data`` lays them out: ``(chunks,
    buckets, Qpad, Npad, per_dev)``. The rank's documents are flat in its
    query order; ``chunks`` are ``ops.sparse_eval.coo_chunks`` of their
    nonzeros; ``buckets`` are ``(labels, mask, didx[, qidx])`` a size class
    (rows as :func:`shard_feat_buckets`), cut into row chunks under the
    pair budget, pads pointing at row ``Npad`` (the largest rank's
    document count) and slot ``Qpad``. A dense ``ds`` works too (a narrow
    validation file beside wide CSR training data). Callers that align
    per-query arrays with the slots (AdaRank's S rows) take ``per_dev``
    from here, never from a second deal."""
    from ranklib_tpu_torch.ops.sparse_eval import coo_chunks

    per_dev, class_rows = deal(ds, n_dev)
    Qpad = max((len(lst) for lst in per_dev), default=0)
    Npad = max((sum(ds.queries[qi].n for _, qi in lst) for lst in per_dev),
               default=1) or 1
    mine = per_dev[rank]
    bk = {D: [np.zeros((rows, D), np.float32), np.zeros((rows, D), bool),
              np.full((rows, D), Npad, np.int64),
              np.full(rows, Qpad, np.int64)]
          for D, rows in class_rows.items()}
    row_of = dict.fromkeys(class_rows, 0)
    f_parts, v_parts, r_parts = [], [], []
    doc0 = 0
    for j, (D, qi) in enumerate(mine):
        q = ds.queries[qi]
        X = query_feats(ds, qi)
        r, f = np.nonzero(X)
        f_parts.append(f.astype(np.int64))
        v_parts.append(np.asarray(X, np.float32)[r, f])
        r_parts.append((r + doc0).astype(np.int64))
        labels, mask, didx, qidx = bk[D]
        row = row_of[D]
        labels[row, : q.n] = q.labels
        mask[row, : q.n] = True
        didx[row, : q.n] = np.arange(doc0, doc0 + q.n)
        qidx[row] = j
        row_of[D] = row + 1
        doc0 += q.n
    cat = (lambda parts, dt: np.concatenate(parts) if parts
           else np.zeros(0, dt))
    chunks = coo_chunks(cat(f_parts, np.int64), cat(v_parts, np.float32),
                        cat(r_parts, np.int64), device)
    buckets = []
    for D in sorted(bk):
        arrs = bk[D] if want_qidx else bk[D][:3]
        rows = class_rows[D]
        step = max(1, min(rows, _PAIR_BUDGET // (D * D)))
        for lo in range(0, rows, step):
            hi = min(lo + step, rows)
            pad = step - (hi - lo)
            fills = (0, False, Npad, Qpad)
            buckets.append(tuple(
                torch.from_numpy(np.pad(
                    a[lo:hi], ((0, pad),) + ((0, 0),) * (a.ndim - 1),
                    constant_values=fill)).to(device)
                for a, fill in zip(arrs, fills)))
    return chunks, buckets, Qpad, Npad, per_dev


@dataclass
class SharedData:
    """A dataset as the ``-dp`` ranks receive it: labels and query
    metadata pickled, the feature arrays in shared memory."""

    queries: list              # Query(qid, labels, None)
    n_features: int
    arrays: dict               # name -> shared-memory tensor
    csr: dict | None = None    # a CSRDataset's other fields

    def open(self) -> Dataset:
        """The dataset over views of the shared arrays (no copy)."""
        a = {k: v.numpy() for k, v in self.arrays.items()}
        if self.csr is None:
            if "feats" not in a:             # labels only
                return Dataset(self.queries, self.n_features)
            flat, qptr = a["feats"], flatten_meta(
                Dataset(self.queries, self.n_features))[1]
            return Dataset([Query(q.qid, q.labels, flat[qptr[i]: qptr[i + 1]])
                            for i, q in enumerate(self.queries)],
                           self.n_features)
        from ranklib_tpu_torch.data.sparse import CSRDataset

        return CSRDataset(queries=self.queries, n_features=self.n_features,
                          **a, **self.csr)


@dataclass
class OwnData:
    """A dataset as a joined process hands it to its own rank: itself
    (every process read the whole file, as every JAX process holds the
    whole array the reference's ``_place`` slices)."""

    ds: Dataset

    def open(self) -> Dataset:
        return self.ds


_CSR_ARRAYS = ("indptr", "fids", "vals", "qrow", "ns_indptr", "ns_fids",
               "ns_a", "ns_b")


def share(ds: Dataset | None, mesh, features: bool = True):
    """``ds`` for the ranks of ``mesh``: spawned ranks get a
    :class:`SharedData` (a dense dataset's features flattened to one
    ``[N, F]`` f32 array, a CSR dataset's arrays as they are; without
    ``features``, its labels and queries only); a joined process's rank,
    :class:`OwnData`, no copy."""
    if ds is None:
        return None
    if mesh.joined:
        return OwnData(ds)
    from ranklib_tpu_torch.models.gbdt import shared

    queries = [Query(q.qid, q.labels, None) for q in ds.queries]
    if not features:
        return SharedData(queries, ds.n_features, {})
    if not hasattr(ds, "materialize_rows"):
        feats = np.empty((ds.n_docs, ds.n_features), np.float32)
        pos = 0
        for q in ds.queries:
            feats[pos: pos + q.n] = q.feats
            pos += q.n
        return SharedData(queries, ds.n_features,
                          {"feats": shared(feats, mesh)})
    arrays = {k: shared(getattr(ds, k), mesh) for k in _CSR_ARRAYS
              if getattr(ds, k) is not None}
    return SharedData(queries, ds.n_features, arrays,
                      {"norm_kind": ds.norm_kind, "ns_width": ds.ns_width})


@dataclass
class ShardJob:
    """One ranker's part of a ``-dp`` fit, as every rank runs it:
    ``ranker.fit_shard(rank, device, group, train, scorer, validation,
    **extra)`` on the opened datasets. Returns (the fitted ranker, its
    launch counts over the fit)."""

    ranker: object
    train: SharedData
    scorer: object
    validation: SharedData | None = None
    extra: dict | None = None

    def __call__(self, rank: int, device, group):
        from ranklib_tpu_torch.models.gbdt import launch_counts, launches_since

        before = launch_counts()
        self.ranker.fit_shard(
            rank, device, group, self.train.open(), self.scorer,
            self.validation.open() if self.validation is not None else None,
            **(self.extra or {}))
        self.ranker.fit_state = None       # device tensors stay here
        return self.ranker, launches_since(before)


def run_jobs(rank: int, device, group, jobs) -> list:
    """The ``parallel.dist.run`` rank function of one or more
    :class:`ShardJob`\\ s, run one after another on the same group."""
    return [job(rank, device, group) for job in jobs]


def check_same_rankers(rankers) -> None:
    """Every ``-dp`` rank must end with the same model: they took the same
    decisions on the same summed statistics."""
    if len({r.model_str() for r in rankers}) != 1:
        raise RankLibError("the -dp ranks ended with different models")


def take_rank0(ranker, results) -> None:
    """After a mesh fit (``results``: each rank's :class:`ShardJob`
    result): check every rank's model, take rank 0's ``MODEL_FIELDS`` into
    ``ranker`` and keep each rank's launch counts in
    ``ranker.rank_launches``."""
    check_same_rankers([r for r, _ in results])
    for f in ranker.MODEL_FIELDS:
        setattr(ranker, f, getattr(results[0][0], f))
    ranker.rank_launches = [c for _, c in results]


def make_job(ranker, mesh, train: Dataset, scorer, validation=None,
             features: bool = True, **extra) -> ShardJob:
    """A :class:`ShardJob` of a copy of ``ranker`` (its hyperparameters,
    no fitted state) on ``train`` and ``validation`` (:func:`share`d for
    ``mesh``, with or without their ``features``); ``extra``: the rest of
    ``fit_shard``'s arguments."""
    worker = copy.copy(ranker)
    worker.rank_launches = None
    if hasattr(worker, "fit_state"):
        worker.fit_state = None          # an earlier fit's device tensors
    return ShardJob(worker, share(train, mesh, features), scorer,
                    share(validation, mesh, features), extra or None)


def fit_many(mesh, fits, profile_dir: str | None = None) -> None:
    """``-dp`` fits in one mesh (spawned ranks start once; each rank's
    trace in ``profile_dir``): ``fits`` are ``(ranker, train, scorer,
    validation)``, run one after another on the same group; each ranker
    ends with rank 0's model."""
    from ranklib_tpu_torch.parallel.dist import run

    jobs = [r.dp_job(mesh, t, s, v) for r, t, s, v in fits]
    out = run(mesh, run_jobs, jobs, profile_dir=profile_dir)
    for i, (ranker, *_) in enumerate(fits):
        take_rank0(ranker, [o[i] for o in out])
