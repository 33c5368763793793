"""Serving flows (ranklib_tpu.evaluator; ref: eval/Evaluator.java:~400+):
load+test with per-query output (``-idv``) and load+rank (``-score``,
``-indri``), on the dense input path. The CLI (``cli``) parses RankLib's
flags, picks the device and dispatches here.
"""

from __future__ import annotations

import numpy as np
import torch

from ranklib_tpu_torch.data.dataset import Dataset, read_feature_file
from ranklib_tpu_torch.data.letor import read_letor
from ranklib_tpu_torch.metrics.base import (
    MetricScorer, create_scorer, score_dataset,
)
from ranklib_tpu_torch.models.base import load_ranker_file
from ranklib_tpu_torch.utils.logging import log, result


def _prepare(path, feature_fids, missing_zero=False) -> Dataset:
    """Read a dense LETOR file and apply ``-feature`` (the dense branch of
    the reference's ``_prepare`` for the load flows)."""
    ds = read_letor(path, missing_zero=missing_zero)
    if feature_fids is not None:
        ds = ds.subset_features(feature_fids)
    return ds


def write_idv(path: str, scorer: MetricScorer, ds: Dataset, per_query) -> None:
    """Per-query metric file (ref: eval/Evaluator.java:~800):
    '<metric>   <qid>   <value>' lines + an 'all' summary row."""
    with open(path, "w") as f:
        for q, v in zip(ds.queries, per_query):
            f.write(f"{scorer.name}   {q.qid}   {v:.4f}\n")
        f.write(f"{scorer.name}   all   {float(np.mean(per_query)):.4f}\n")
    log(f"Per-ranked-list performance saved to: {path}")


def write_score_file(path: str, ds: Dataset, scores) -> None:
    """'<qid>\\t<docIndex>\\t<score>' lines (ref: Evaluator score flow)."""
    with open(path, "w") as f:
        for q, s in zip(ds.queries, scores):
            for i, v in enumerate(s):
                f.write(f"{q.qid}\t{i}\t{float(v):.6f}\n")
    log(f"Scores saved to: {path}")


def write_indri_rankings(path: str, ds: Dataset, scores) -> None:
    """Indri-style reranking output (ref: Evaluator -indri flow):
    '<qid> Q0 <docid> <rank> <score> indri' in score-descending order
    (stable). The docid is the raw '#' description with every '#'
    removed, trimmed, as the reference writes it."""
    with open(path, "w") as f:
        for q, s in zip(ds.queries, scores):
            order = np.argsort(-np.asarray(s), kind="stable")
            for rank, idx in enumerate(order, start=1):
                desc = q.descs[idx] if q.descs and q.descs[idx] else ""
                docid = desc.replace("#", "").strip() or f"doc{idx}"
                f.write(f"{q.qid} Q0 {docid} {rank} {float(s[idx]):.6f} "
                        f"indri\n")
    log(f"Reranked lists saved to: {path}")


def evaluate_test_only(args, device: torch.device) -> None:
    """Flow 3.3: -load model -test file -metric2T metric [-idv file]."""
    scorer = create_scorer(args.metric2T or args.metric2t, gmax=args.gmax)
    ranker = load_ranker_file(args.load)
    feature_fids = read_feature_file(args.feature) if args.feature else None
    test = _prepare(args.test, feature_fids, missing_zero=args.missingZero)
    m, per_q = score_dataset(scorer, test, ranker.eval_dataset(test, device),
                             device)
    result(f"{scorer.name} on test data: {m:.4f}")
    if args.idv:
        write_idv(args.idv, scorer, test, per_q)


def evaluate_rank(args, device: torch.device) -> None:
    """Flow 3.3: -load model -rank file [-score out] [-indri out]."""
    ranker = load_ranker_file(args.load)
    feature_fids = read_feature_file(args.feature) if args.feature else None
    data = _prepare(args.rank, feature_fids, missing_zero=args.missingZero)
    scores = ranker.eval_dataset(data, device)
    if args.score:
        write_score_file(args.score, data, scores)
    if args.indri:
        write_indri_rankings(args.indri, data, scores)
    if not args.score and not args.indri:
        # no implicit side-effect file: print the reranking instead (it is
        # the flow's result, so -silent does not swallow it)
        for q, s in zip(data.queries, scores):
            order = np.argsort(-np.asarray(s), kind="stable")
            result(f"{q.qid}\t" + " ".join(str(int(i)) for i in order))
