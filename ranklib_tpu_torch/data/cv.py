"""Query splits (ranklib_tpu.data.cv).

Deterministic round-robin k-fold assignment, no shuffle (ref:
features/FeatureManager.java:~200 prepareCV): query i lands in test fold
``i % k``; the other folds, in fold order, form its training set. With
``tvs`` (ref: Evaluator -tvs) the tail of each fold's training queries
becomes validation. ``split_tvs`` serves -tvs and -tts on one file.
A ``-sparse`` CSR dataset (it has ``subset_queries``) splits into row
copies; the tree rankers bin each split on its own grid afterwards. A
streamed bin matrix (``data.binned.BinnedDataset``, the shared grid of
``RANKLIB_TPU_KCV_SHARED_GRID=1``) splits into its rows on that grid.
"""

from __future__ import annotations

from ranklib_tpu_torch.data.dataset import Dataset
from ranklib_tpu_torch.utils.errors import RankLibError


def prepare_cv(ds: Dataset, n_fold: int, tvs: float = -1.0, lazy=False):
    """(train, validation_or_None, test) Dataset triples, one a fold — a
    list, or a per-fold generator with ``lazy=True``. Dense folds share
    the Query objects of ``ds``; CSR folds copy their rows
    (``subset_queries``), so the evaluator iterates lazily and holds one
    fold's copies at a time."""
    if n_fold < 2:
        raise RankLibError(f"Need at least 2 folds, got {n_fold}")
    if len(ds.queries) < n_fold:
        raise RankLibError(
            f"Cannot make {n_fold} folds from {len(ds.queries)} queries")
    fold_test = [list(range(f, len(ds.queries), n_fold))
                 for f in range(n_fold)]

    if hasattr(ds, "subset_queries"):        # CSR or bin-matrix row subsets
        make = ds.subset_queries
    else:
        def make(idxs):
            return Dataset([ds.queries[i] for i in idxs], ds.n_features)

    def one_fold(f):
        train = [i for g in range(n_fold) if g != f for i in fold_test[g]]
        valid = None
        if tvs and tvs > 0:
            n_train = int(len(train) * tvs)
            if n_train < 1 or n_train >= len(train):
                raise RankLibError(
                    f"-tvs {tvs} leaves an empty train or validation split")
            valid = make(train[n_train:])
            train = train[:n_train]
        return make(train), valid, make(fold_test[f])

    if lazy:
        return (one_fold(f) for f in range(n_fold))
    return [one_fold(f) for f in range(n_fold)]


def split_tvs(ds: Dataset, tvs: float):
    """Split one dataset into (first ``tvs`` of the queries, the rest)
    (ref: -tvs / -tts)."""
    n_train = int(len(ds.queries) * tvs)
    if n_train < 1 or n_train >= len(ds.queries):
        raise RankLibError(
            f"-tvs {tvs} leaves an empty train or validation split")
    if hasattr(ds, "subset_queries"):        # CSRDataset keeps its CSR
        return (ds.subset_queries(range(n_train)),
                ds.subset_queries(range(n_train, len(ds.queries))))
    return (Dataset(ds.queries[:n_train], ds.n_features),
            Dataset(ds.queries[n_train:], ds.n_features))
