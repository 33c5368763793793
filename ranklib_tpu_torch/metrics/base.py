"""MetricScorer facade + factory (ranklib_tpu.metrics.base; ref:
metric/MetricScorerFactory.java:~15).

Metric strings are API surface: ``MAP``, ``NDCG@10``, ``DCG@10``, ``P@10``,
``RR@10``, ``ERR@10``, ``BEST@10`` (case-insensitive; a missing ``@k``
defaults to k=10, like the reference).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ranklib_tpu_torch.data.dataset import Dataset, bucketize
from ranklib_tpu_torch.metrics import scorers as S
from ranklib_tpu_torch.ops.sorting import rank_labels, rank_perm
from ranklib_tpu_torch.utils.errors import RankLibError

_METRICS = {
    # name -> (score_fn(L, n, k), uses_k)
    "MAP": (S.ap_score, False),
    "NDCG": (S.ndcg_score, True),
    "DCG": (S.dcg_score, True),
    "P": (S.precision_score, True),
    "RR": (S.rr_score, True),
    "ERR": (S.err_score, True),
    "BEST": (S.best_score, True),
}


class MetricScorer:
    """One metric with a fixed cutoff k."""

    def __init__(self, name: str, k: int = 10, gmax: float = 4.0):
        name = name.upper()
        if name not in _METRICS:
            raise RankLibError(f"Unknown metric '{name}'")
        self.metric = name
        self.k = int(k)
        self.gmax = float(gmax)
        score_fn, self.uses_k = _METRICS[name]
        kk = self.k if self.uses_k else 0
        if name == "ERR":
            self._score = functools.partial(score_fn, k=kk, gmax=self.gmax)
        else:
            self._score = functools.partial(score_fn, k=kk)

    @property
    def name(self) -> str:
        """Display name, e.g. 'NDCG@10' or 'MAP' (console and -idv files)."""
        if self.uses_k:
            return f"{self.metric}@{self.k}"
        return self.metric

    def score_from_scores(self, labels: torch.Tensor, scores: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
        """Rank by scores (stable desc) then score → [B].

        Truncated metrics with k < D score only the top k positions, as the
        reference's ``lax.top_k`` path does (so sums run over the same k
        terms); the top k come from the stable sort, whose tie order is
        the lower index first, MergeSorter's contract.
        """
        n = mask.sum(dim=-1).to(torch.int32)
        D = labels.shape[-1]
        k = self.k
        if self.metric != "MAP" and self.uses_k and 0 < k < D:
            nk = torch.clamp(n, max=k)
            pos_ok = (torch.arange(k, device=labels.device)[None, :]
                      < nk[:, None])
            top = rank_perm(scores, mask)[:, :k]
            Lk = torch.where(pos_ok, torch.gather(labels, -1, top), 0.0)
            if self.metric == "NDCG":
                # ideal = top-k LABELS over the whole list
                Li = torch.sort(torch.where(mask, labels, -torch.inf),
                                dim=-1, descending=True).values[:, :k]
                Li = torch.where(pos_ok, Li, 0.0)
                ideal = S.dcg_score(Li, nk, k)
                dcg = S.dcg_score(Lk, nk, k)
                return torch.where(
                    ideal > 0, dcg / torch.where(ideal > 0, ideal, 1.0), 0.0)
            return self._score(Lk, nk)
        return self._score(rank_labels(labels, scores, mask), n)


def create_scorer(metric: str, gmax: float = 4.0) -> MetricScorer:
    """Parse 'NDCG@10' / 'MAP' / ... → MetricScorer."""
    m = metric.strip().upper()
    if "@" in m:
        name, _, kstr = m.partition("@")
        try:
            k = int(kstr)
        except ValueError:
            raise RankLibError(f"Bad metric cutoff in '{metric}'") from None
    else:
        name, k = m, 10
    return MetricScorer(name, k, gmax)


def score_dataset(scorer: MetricScorer, ds: Dataset, scores_per_query,
                  device: torch.device):
    """Macro-averaged metric over a dataset given per-query score arrays,
    computed on ``device``. Returns (mean, per_query [Q] float64) — the
    reference's scoreAll and the per-query values ``-idv`` writes (ref:
    metric/MetricScorer.java scoreAll; eval/Evaluator.java:~800)."""
    per_query = np.zeros(len(ds.queries), dtype=np.float64)
    for b in bucketize(ds):
        sc = np.zeros((b.B, b.D), dtype=np.float32)
        for row, qi in enumerate(b.qidx):
            s = scores_per_query[qi]
            sc[row, : len(s)] = s
        vals = scorer.score_from_scores(torch.from_numpy(b.labels).to(device),
                                        torch.from_numpy(sc).to(device),
                                        torch.from_numpy(b.mask).to(device))
        per_query[b.qidx] = vals.cpu().numpy()
    return float(per_query.mean()), per_query
