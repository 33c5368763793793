"""Orchestration flows (ranklib_tpu.evaluator; ref: eval/Evaluator.java:~400+)
on the dense input path: train (+validate) (+test) (+save), load+test
with per-query output (``-idv``) and load+rank (``-score``, ``-indri``).
The CLI (``cli``) parses RankLib's flags, picks the device and dispatches
here.
"""

from __future__ import annotations

import numpy as np
import torch

from ranklib_tpu_torch.data.cv import split_tvs
from ranklib_tpu_torch.data.dataset import Dataset, read_feature_file
from ranklib_tpu_torch.data.letor import read_letor
from ranklib_tpu_torch.metrics.base import (
    MetricScorer, create_scorer, score_dataset,
)
from ranklib_tpu_torch.models.base import Ranker, load_ranker_file
from ranklib_tpu_torch.models.trainer import train_ranker
from ranklib_tpu_torch.utils.logging import log, result


def _prepare(path, feature_fids, missing_zero=False, must_have_rel=False,
             n_features=None) -> Dataset:
    """Read a dense LETOR file, align it to the training width and apply
    ``-feature`` (the dense branch of the reference's ``_prepare``)."""
    ds = read_letor(path, missing_zero=missing_zero,
                    must_have_rel_doc=must_have_rel, n_features=n_features)
    if n_features is not None and ds.n_features != n_features:
        # fids above the training width are unusable by the model: clip
        log(f"[{path}] feature width {ds.n_features} -> {n_features} "
            f"(aligned to the training feature space)")
        ds = ds.with_width(n_features)
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


def evaluate_train(args, device: torch.device) -> Ranker:
    """Flow 3.1: -train (+ -validate or -tvs) (+ -test or -tts) (+ -save)."""
    feature_fids = read_feature_file(args.feature) if args.feature else None
    train_scorer = create_scorer(args.metric2t, gmax=args.gmax)
    test_scorer = (create_scorer(args.metric2T, gmax=args.gmax)
                   if args.metric2T else train_scorer)
    must_rel = train_scorer.needs_rel
    train = _prepare(args.train, feature_fids, args.missingZero, must_rel)
    split_test = None
    has_tts = bool(args.tts) and args.tts > 0
    if has_tts:
        # -tts carves the test set out of the training file; it overrides
        # -tvs and an explicit -test file (ref: Evaluator -tts precedence)
        train, split_test = split_tvs(train, args.tts)
        log(f"Train-test split: {len(train.queries)} / "
            f"{len(split_test.queries)} queries")
    validation = None
    if args.validate:
        validation = _prepare(args.validate, feature_fids, args.missingZero,
                              must_rel, n_features=train.n_features)
    elif args.tvs and args.tvs > 0 and not has_tts:
        train, validation = split_tvs(train, args.tvs)
    ranker = train_ranker(args.ranker, train, train_scorer, validation,
                          args.hparams, device)
    m_train, _ = score_dataset(train_scorer, train,
                               ranker.eval_dataset(train, device), device)
    result(f"{train_scorer.name} on training data: {m_train:.4f}")
    if validation is not None:
        m_val, _ = score_dataset(train_scorer, validation,
                                 ranker.eval_dataset(validation, device),
                                 device)
        result(f"{train_scorer.name} on validation data: {m_val:.4f}")
    if args.test or split_test is not None:
        test = (split_test if split_test is not None else
                _prepare(args.test, feature_fids, args.missingZero,
                         n_features=train.n_features))
        m_test, per_q = score_dataset(test_scorer, test,
                                      ranker.eval_dataset(test, device),
                                      device)
        result(f"{test_scorer.name} on test data: {m_test:.4f}")
        if args.idv:
            write_idv(args.idv, test_scorer, test, per_q)
    if args.save:
        ranker.save(args.save)
    return ranker


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
