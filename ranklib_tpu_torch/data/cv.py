"""Query splits (the dense branch of ranklib_tpu.data.cv; ref: Evaluator
-tvs / -tts). k-fold ``prepare_cv`` belongs to the ``-kcv`` flow, which is
not ported yet."""

from __future__ import annotations

from ranklib_tpu_torch.data.dataset import Dataset
from ranklib_tpu_torch.utils.errors import RankLibError


def split_tvs(ds: Dataset, tvs: float):
    """Split one dataset into (first ``tvs`` of the queries, the rest)
    (ref: -tvs / -tts)."""
    n_train = int(len(ds.queries) * tvs)
    if n_train < 1 or n_train >= len(ds.queries):
        raise RankLibError(
            f"-tvs {tvs} leaves an empty train or validation split")
    return (Dataset(ds.queries[:n_train], ds.n_features),
            Dataset(ds.queries[n_train:], ds.n_features))
