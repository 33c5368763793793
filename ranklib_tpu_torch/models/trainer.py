"""Training harness (ranklib_tpu.models.trainer; ref:
learning/RankerTrainer.java:~20): create the ranker from ``-ranker N`` and
its hyperparameters, fit it on an explicit device, and print the
wall-clock training time, the reference's only profiling output.
"""

from __future__ import annotations

import time

import torch

from ranklib_tpu_torch.data.dataset import Dataset
from ranklib_tpu_torch.metrics.base import MetricScorer
from ranklib_tpu_torch.models.base import Ranker, get_ranker_class
from ranklib_tpu_torch.utils.logging import log


def train_ranker(ranker_type, train: Dataset, scorer: MetricScorer,
                 validation: Dataset | None, hparams: dict | None,
                 device: torch.device, feature_mask=None) -> Ranker:
    """``feature_mask`` (``-feature`` on the streamed ``-sparse`` path, a
    tree ranker's) reaches the fit as a split mask: for trees exactly the
    dense pipeline's column zeroing."""
    ranker = get_ranker_class(ranker_type)(**dict(hparams or {}))
    kwargs = {} if feature_mask is None else {"feature_mask": feature_mask}
    t0 = time.perf_counter()
    ranker.fit(train, scorer, validation, device=device, **kwargs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log("")
    log(f"Training time: {time.perf_counter() - t0:.2f} seconds")
    return ranker
