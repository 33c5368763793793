"""The Ranker contract and factory (ranklib_tpu.models.base).

The reference addresses algorithms by ``-ranker N`` integer (ref:
learning/RankerType.java:~10) or display name (ref:
learning/RankerFactory.java:~30); those and the ``## <Name>`` model-file
header line are API surface and preserved exactly. Scoring takes an
explicit ``torch.device``.

All ten rankers are ported: LambdaMART and MART (``models.gbdt``),
Random Forests (``models.rf``), Coordinate Ascent
(``models.coorascent``), Linear Regression (``models.linear``),
RankBoost (``models.rankboost``), AdaRank (``models.adarank``) and
RankNet, LambdaRank and ListNet (``models.neural``). Hyperparameters are
per-instance attributes set from ``**hp`` (the reference sets public
static fields; neither package keeps that global state).
"""

from __future__ import annotations

import numpy as np
import torch

from ranklib_tpu_torch.data.dataset import Dataset
from ranklib_tpu_torch.utils.errors import RankLibError
from ranklib_tpu_torch.utils.logging import log

# -ranker N → canonical display name (ref: RankerType enum, CLI order)
RANKER_NAMES = {
    0: "MART",
    1: "RankNet",
    2: "RankBoost",
    3: "AdaRank",
    4: "Coordinate Ascent",
    5: "LambdaRank",
    6: "LambdaMART",
    7: "ListNet",
    8: "Random Forests",
    9: "Linear Regression",
}

_REGISTRY = {}  # display name -> class


def register_ranker(cls):
    """Class decorator: register under cls.NAME."""
    _REGISTRY[cls.NAME] = cls
    return cls


def get_ranker_class(name):
    """Resolve a display name (a model file's ``## <Name>``) or a
    ``-ranker N`` id to a class."""
    from ranklib_tpu_torch.models import (  # noqa: F401  (register)
        adarank, coorascent, gbdt, linear, neural, rankboost, rf,
    )

    if isinstance(name, int):
        if name not in RANKER_NAMES:
            raise RankLibError(f"Unknown ranker type {name}")
        name = RANKER_NAMES[name]
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise RankLibError(f"Unknown ranker '{name}'")


class Ranker:
    """Base class: the serving half of the reference Ranker's contract."""

    NAME = "?"

    def __init__(self, **hparams):
        for k, v in hparams.items():
            if not hasattr(self, k):
                raise RankLibError(f"{self.NAME}: unknown hyperparameter '{k}'")
            setattr(self, k, v)

    def fit(self, train: Dataset, scorer, validation: Dataset | None = None,
            device: torch.device | None = None) -> None:
        raise NotImplementedError

    def eval_dataset(self, ds: Dataset, device: torch.device) -> list:
        """Per-query score arrays (list aligned with ds.queries)."""
        raise NotImplementedError

    def rank_dataset(self, ds: Dataset, device: torch.device) -> list:
        """Per-query permutations sorting the documents by score,
        descending and stable (ref ``rank_dataset``, base.py:93; the
        reference's Ranker.rank sorts with a merge sort)."""
        return [np.argsort(-np.asarray(s), kind="stable")
                for s in self.eval_dataset(ds, device)]

    def score_metric(self, ds: Dataset, scorer,
                     device: torch.device) -> float:
        """The macro-averaged metric of this model's scores of ``ds``
        (ref ``score_metric``, base.py:100), computed on ``device``."""
        from ranklib_tpu_torch.metrics.base import score_dataset

        return score_dataset(scorer, ds, self.eval_dataset(ds, device),
                             device)[0]

    def model_str(self) -> str:
        """Text model body, RankLib-interoperable."""
        raise NotImplementedError

    def load_str(self, text: str) -> None:
        raise NotImplementedError

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.model_str())
        log(f"Model saved to: {path}")


def load_ranker_file(path: str) -> Ranker:
    """Instantiate + load from a text model file; the first line
    ``## <Name>`` is the dispatcher (ref: RankerFactory.loadRankerFromFile,
    learning/RankerFactory.java:~90)."""
    with open(path) as f:
        text = f.read()
    first = text.split("\n", 1)[0].strip()
    if not first.startswith("## "):
        raise RankLibError(f"Model file {path} missing '## <Name>' header")
    r = get_ranker_class(first[3:].strip())()
    r.load_str(text)
    return r


def model_header(name: str, params: dict) -> str:
    """'## <Name>' + '## key = value' comment lines (reference format)."""
    lines = [f"## {name}"]
    for k, v in params.items():
        lines.append(f"## {k} = {v}")
    return "\n".join(lines) + "\n"


def parse_model_params(text: str):
    """Parse '## key = value' comment lines; returns (params, body_lines)."""
    params = {}
    body = []
    for line in text.splitlines():
        if line.startswith("##"):
            inner = line[2:].strip()
            if "=" in inner:
                k, _, v = inner.partition("=")
                params[k.strip()] = v.strip()
        elif line.strip():
            body.append(line)
    return params, body
