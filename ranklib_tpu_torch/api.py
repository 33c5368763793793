"""The library face of the CLI (ranklib_tpu.api)::

    import ranklib_tpu_torch.api as rl

    train = rl.read("train.txt")
    test = rl.read("test.txt")
    model = rl.train(train, ranker=6, metric="NDCG@10", n_trees=300)
    print(rl.evaluate(model, test, metric="NDCG@10"))   # macro-averaged
    rl.save(model, "model.txt")                         # RankLib text format

    model = rl.load("model.txt")
    ranked = rl.rank(model, test)        # per-query doc orderings
    scores = rl.score(model, test)       # per-query score arrays

A ranker is a ``-ranker`` integer (0-9) or a display name
("LambdaMART"); hyperparameters are the rankers' attributes (``n_trees``,
``n_leaves``, ``learning_rate``, ...) rather than CLI flags. Every
function that computes takes ``device=``; by default the CLI's
(:func:`~ranklib_tpu_torch.device.choose_device`: the card, or the CPU
when ``RANKLIB_TPU_TORCH_DEVICE=cpu`` asks for it).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ranklib_tpu_torch.data.dataset import Dataset
from ranklib_tpu_torch.device import choose_device
from ranklib_tpu_torch.metrics.base import create_scorer, score_dataset
from ranklib_tpu_torch.models.base import Ranker, load_ranker_file
from ranklib_tpu_torch.models.trainer import train_ranker
from ranklib_tpu_torch.utils.logging import is_silent, set_silent

__all__ = ["read", "train", "evaluate", "rank", "score", "save", "load",
           "Dataset", "Ranker"]


@contextlib.contextmanager
def _quiet():
    was = is_silent()
    set_silent(True)
    try:
        yield
    finally:
        set_silent(was)


def _device(device) -> torch.device:
    return choose_device(quiet=True) if device is None else torch.device(
        device)


def read(path: str, must_have_rel_doc: bool = False,
         n_features: int | None = None, sparse: bool = False,
         descs: bool = False) -> Dataset:
    """A LETOR/SVMLight file (gzip ok) as a Dataset, read without console
    lines. ``sparse=True``: into host CSR (the CLI's ``-sparse`` storage
    of the raw-value rankers; dense blocks materialize in bounded chunks,
    the trained models are the dense ones); ``descs=True`` keeps the '#'
    descriptions of a sparse read (the dense reader always keeps them)."""
    with _quiet():
        if sparse:
            from ranklib_tpu_torch.data.sparse import read_letor_sparse

            return read_letor_sparse(path, must_have_rel_doc=must_have_rel_doc,
                                     n_features=n_features, quiet=True,
                                     want_descs=descs)
        from ranklib_tpu_torch.data.letor import read_letor

        return read_letor(path, must_have_rel_doc=must_have_rel_doc,
                          n_features=n_features)


def train(data: Dataset | str, ranker=6, metric: str = "NDCG@10",
          validation: Dataset | str | None = None, gmax: float = 4.0,
          n_dp: int = 0, device=None, **hyperparams) -> Ranker:
    """Train a ranker (``-ranker`` integer or display name; an unknown one
    raises RankLibError) through the CLI's trainer. ``n_dp > 1``:
    data-parallel over that many devices (the tree rankers). A path is
    read as the CLI reads it: when the metric needs relevance (MAP, P,
    RR) queries without a relevant document are dropped."""
    device = _device(device)
    scorer = create_scorer(metric, gmax=gmax)
    if isinstance(data, str):
        data = read(data, must_have_rel_doc=scorer.needs_rel)
    if isinstance(validation, str):
        validation = read(validation, must_have_rel_doc=scorer.needs_rel,
                          n_features=data.n_features)
    return train_ranker(ranker, data, scorer, validation, hyperparams,
                        device, n_dp=n_dp)


def evaluate(model: Ranker, data: Dataset | str, metric: str = "NDCG@10",
             gmax: float = 4.0, per_query: bool = False, device=None):
    """The model's macro-averaged metric on a dataset (ref: scoreAll);
    ``per_query=True`` also returns the [Q] values ``-idv`` writes."""
    device = _device(device)
    if isinstance(data, str):
        data = read(data)
    scorer = create_scorer(metric, gmax=gmax)
    mean, pq = score_dataset(scorer, data, model.eval_dataset(data, device),
                             device)
    return (mean, pq) if per_query else mean


def score(model: Ranker, data: Dataset | str, device=None) -> list:
    """Per-query score arrays, in each query's document order."""
    device = _device(device)
    if isinstance(data, str):
        data = read(data)
    return [np.asarray(s) for s in model.eval_dataset(data, device)]


def rank(model: Ranker, data: Dataset | str, device=None) -> list:
    """Per-query document permutations, best first; ties keep document
    order (the reference's stable MergeSorter)."""
    return [np.argsort(-s, kind="stable")
            for s in score(model, data, device)]


def save(model: Ranker, path: str) -> None:
    """Write the RankLib text model (``## <Name>`` header)."""
    model.save(path)


def load(path: str) -> Ranker:
    """Load any RankLib model file (its header picks the ranker)."""
    return load_ranker_file(path)
