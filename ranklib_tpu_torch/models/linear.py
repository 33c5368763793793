"""Linear Regression (`-ranker 9`; ranklib_tpu.models.linear; ref:
learning/LinearRegRank.java).

Pointwise least squares of labels on features with ridge ``-L2`` (default
1e-10) on the diagonal. The normal equations XᵀX, Xᵀy accumulate in f64
on the host, a block of rows at a time (a ``-sparse`` CSR file's
materialized alone, so that it sums as its dense file does), and the
(F+1)² system is solved there, as the reference does: a device product
in f32 (or TF32) skews the ill-conditioned ridge solve. Scoring runs on
the device in f32.
Model line: ``0:<intercept> 1:<w1> ...``.
"""

from __future__ import annotations

import numpy as np
import torch

from ranklib_tpu_torch.data.dataset import Dataset, flatten_meta
from ranklib_tpu_torch.device import choose_device
from ranklib_tpu_torch.metrics.base import score_dataset
from ranklib_tpu_torch.models.base import (
    Ranker, model_header, parse_model_params, register_ranker,
)
from ranklib_tpu_torch.ops.batched_eval import linear_scores, materializer
from ranklib_tpu_torch.utils.errors import RankLibError
from ranklib_tpu_torch.utils.logging import log


@register_ranker
class LinearRegRank(Ranker):
    NAME = "Linear Regression"

    def __init__(self, **hp):
        self.lam = 1e-10          # ridge lambda (-L2)
        self.weights = None       # np.float64 [F + 1]; [0] = intercept
        super().__init__(**hp)

    def fit(self, train: Dataset, scorer=None, validation=None,
            device: torch.device | None = None) -> None:
        F = train.n_features
        xtx = np.zeros((F + 1, F + 1), np.float64)
        xty = np.zeros((F + 1,), np.float64)
        # blocks of ≤ 2^22 f64 design values (32 MB), each materialized
        # alone: a CSR file sums the dense file's blocks in its order
        labels, _ = flatten_meta(train)
        N = train.n_docs
        materialize = materializer(train)
        rows = max(1, (1 << 22) // (F + 1))
        for lo in range(0, N, rows):
            hi = min(lo + rows, N)
            Xd = np.empty((hi - lo, F + 1), np.float64)
            Xd[:, 0] = 1.0
            Xd[:, 1:] = materialize(lo, hi)
            xtx += Xd.T @ Xd
            xty += Xd.T @ labels[lo:hi].astype(np.float64)
        xtx[np.diag_indices_from(xtx)] += self.lam
        try:
            self.weights = np.linalg.solve(xtx, xty)
        except np.linalg.LinAlgError as e:
            raise RankLibError("Normal equations are singular") from e
        if scorer is not None:
            device = choose_device(quiet=True) if device is None else device
            m, _ = score_dataset(scorer, train,
                                 self.eval_dataset(train, device), device)
            log(f"{scorer.name} on training data: {m:.4f}")

    def eval_dataset(self, ds: Dataset, device: torch.device):
        if self.weights is None:
            raise RankLibError("Model not trained/loaded")
        w = self.weights
        return linear_scores(ds, w[1:], device, bias=float(w[0]))

    def model_str(self) -> str:
        body = " ".join(f"{i}:{self.weights[i]}"
                        for i in range(len(self.weights)))
        return model_header(self.NAME, {"Lambda": self.lam}) + body + "\n"

    def load_str(self, text: str) -> None:
        params, body = parse_model_params(text)
        if "Lambda" in params:
            self.lam = float(params["Lambda"])
        if not body:
            raise RankLibError("Empty Linear Regression model body")
        pairs = body[0].split()
        max_id = max(int(p.split(":")[0]) for p in pairs)
        w = np.zeros(max_id + 1, np.float64)
        for p in pairs:
            i, _, v = p.partition(":")
            w[int(i)] = float(v)
        self.weights = w
