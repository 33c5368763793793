"""MART (`-ranker 0`) and LambdaMART (`-ranker 6`): load, score, save
(ranklib_tpu.models.gbdt; ref: learning/tree/LambdaMART.java,
learning/tree/MART.java).

A model is a :class:`TreeEnsemble` plus the reference's header fields
(``-tree`` 1000, ``-leaf`` 10, ``-shrinkage`` 0.1, ``-tc`` 256,
``-estop`` 100). Training (``fit``) is the next slice of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from ranklib_tpu_torch.data.dataset import Dataset, flatten
from ranklib_tpu_torch.gbdt.ensemble import TreeEnsemble
from ranklib_tpu_torch.models.base import (
    Ranker, model_header, parse_model_params, register_ranker,
)
from ranklib_tpu_torch.utils.errors import RankLibError


@register_ranker
class LambdaMART(Ranker):
    NAME = "LambdaMART"

    def __init__(self):
        self.n_trees = 1000
        self.n_leaves = 10
        self.learning_rate = 0.1
        self.n_threshold = 256
        self.early_stop = 100
        self.ensemble = TreeEnsemble()

    def fit(self, train, scorer, validation=None) -> None:
        raise NotImplementedError(
            f"{self.NAME}.fit belongs to the training slice (histogram, "
            f"split scan, lambdas, tree growth), not yet ported to "
            f"ranklib_tpu_torch; train with ranklib_tpu and -load the model")

    def eval_dataset(self, ds: Dataset, device: torch.device):
        if not len(self.ensemble):
            raise RankLibError("Model not trained/loaded")
        return eval_ensemble_dataset(self.ensemble, ds, device)

    def model_str(self) -> str:
        return model_header(self.NAME, {
            "No. of trees": len(self.ensemble),
            "No. of leaves": self.n_leaves,
            "No. of threshold candidates": self.n_threshold,
            "Learning rate": self.learning_rate,
            "Stop early": self.early_stop,
        }) + "\n" + self.ensemble.to_text()

    def load_str(self, text: str) -> None:
        params, _ = parse_model_params(text)
        try:
            if "No. of leaves" in params:
                self.n_leaves = int(params["No. of leaves"])
            if "Learning rate" in params:
                self.learning_rate = float(params["Learning rate"])
            if "No. of trees" in params:
                self.n_trees = int(params["No. of trees"])
        except ValueError as e:
            raise RankLibError(f"Bad model header value: {e}") from None
        self.ensemble = TreeEnsemble.from_text(text)


@register_ranker
class MART(LambdaMART):
    """Pointwise GBRT (ref: learning/tree/MART.java:~15): the same model
    and file format; only training differs."""

    NAME = "MART"


def eval_ensemble_dataset(ensemble: TreeEnsemble, ds: Dataset,
                          device: torch.device):
    """Per-query scores of a TreeEnsemble over a dense dataset (ref
    ``eval_ensemble_dataset``, :434): flatten, pad the width to the
    model's largest fid, one ``eval_matrix`` call."""
    max_fid = 1 + max(int(t.feature.max()) for t in ensemble.trees)
    feats, _, qptr = flatten(ds)
    if feats.shape[1] < max_fid:
        feats = np.pad(feats, ((0, 0), (0, max_fid - feats.shape[1])))
    flat = ensemble.eval_matrix(feats, device)
    return [flat[qptr[i]: qptr[i + 1]] for i in range(len(ds.queries))]
