"""The Ranker contract and factory (ranklib_tpu.models.base).

The reference addresses algorithms by ``-ranker N`` integer (ref:
learning/RankerType.java:~10) or display name (ref:
learning/RankerFactory.java:~30); those and the ``## <Name>`` model-file
header line are API surface and preserved exactly. Scoring takes an
explicit ``torch.device``.

Ported rankers: LambdaMART and MART (``models.gbdt``). A known name that
is not ported yet raises RankLibError saying so. Hyperparameters are
per-instance attributes set from ``**hp`` (the reference sets public
static fields; neither package keeps that global state).
"""

from __future__ import annotations

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
    from ranklib_tpu_torch.models import gbdt  # noqa: F401  (registers)

    if isinstance(name, int):
        if name not in RANKER_NAMES:
            raise RankLibError(f"Unknown ranker type {name}")
        name = RANKER_NAMES[name]
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in RANKER_NAMES.values():
        raise RankLibError(
            f"Ranker '{name}' is not yet ported to ranklib_tpu_torch "
            f"(ported: {', '.join(sorted(_REGISTRY))})")
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
