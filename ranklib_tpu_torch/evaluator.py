"""Orchestration flows (ranklib_tpu.evaluator; ref: eval/Evaluator.java:~400+):
train (+validate) (+test) (+save), k-fold cross validation (``-kcv``),
load+test with per-query output (``-idv``) and load+rank (``-score``,
``-indri``); ``-qrel`` relabels every file a flow reads. The CLI (``cli``)
parses RankLib's flags, picks the device and dispatches here.

``-sparse`` serves the tree rankers (0, 6, 8) and loaded tree models. Their
training files stream straight to the int16 bin matrix
(``data.binned.read_letor_binned``); under ``-norm``, and for the
``-tvs``/``-tts`` split grids and ``-kcv`` folds, they land in host CSR
(``data.sparse``) and bin in bounded chunks (``binned_from_csr``). Load
flows read CSR. A loader that does not apply logs ``[-sparse] … not
applicable`` and the flow runs the dense pipeline, as the reference does.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ranklib_tpu_torch.data.cv import prepare_cv, split_tvs
from ranklib_tpu_torch.data.dataset import (
    Dataset, feature_mask_from_fids, read_feature_file,
)
from ranklib_tpu_torch.data.letor import read_letor
from ranklib_tpu_torch.data.normalize import normalize_dataset
from ranklib_tpu_torch.data.qrel import apply_qrel
from ranklib_tpu_torch.metrics.base import (
    MetricScorer, create_scorer, score_dataset,
)
from ranklib_tpu_torch.models.base import Ranker, load_ranker_file
from ranklib_tpu_torch.models.trainer import train_ranker
from ranklib_tpu_torch.utils.errors import RankLibError
from ranklib_tpu_torch.utils.logging import log, result

_TREE_RANKERS = (0, 6, 8)


def _prepare(path, feature_fids, missing_zero=False, must_have_rel=False,
             n_features=None, norm=None, qrel=None, sparse=False,
             want_descs=False) -> Dataset:
    """Read a LETOR file, align it to the training width, relabel it from
    ``-qrel``, apply ``-feature``, then ``-norm``. ``sparse``: into host CSR
    (``-norm`` applied lazily; ``want_descs`` or ``-qrel`` also fetch the
    '#' descriptions)."""
    if sparse:
        from ranklib_tpu_torch.data.sparse import (
            normalize_csr, read_letor_sparse,
        )

        ds = read_letor_sparse(path, must_have_rel_doc=must_have_rel,
                               n_features=n_features,
                               missing_zero=missing_zero,
                               want_descs=want_descs or bool(qrel))
        if n_features is not None and ds.n_features != n_features:
            ds = ds.with_width(n_features)
        if qrel:
            apply_qrel(ds, qrel)
        if feature_fids is not None:
            ds = ds.subset_features(feature_fids)
        if norm:
            ds = normalize_csr(ds, norm)
        return ds
    ds = read_letor(path, missing_zero=missing_zero,
                    must_have_rel_doc=must_have_rel, n_features=n_features)
    if n_features is not None and ds.n_features != n_features:
        # fids above the training width are unusable by the model: clip
        log(f"[{path}] feature width {ds.n_features} -> {n_features} "
            f"(aligned to the training feature space)")
        ds = ds.with_width(n_features)
    if qrel:
        apply_qrel(ds, qrel)
    if feature_fids is not None:
        ds = ds.subset_features(feature_fids)
    if norm:
        normalize_dataset(ds, norm)
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


def _sparse_tree(args) -> bool:
    """-sparse for a tree ranker. Without -norm the file goes through the
    streamed parse→bin loader (``data.binned``; ``-qrel`` streams the '#'
    descriptions as a side-array, ``-feature`` becomes a split mask, for
    trees exactly the dense column zeroing). Under -norm the streamed
    passes would see raw values only, so the file lands in host CSR with
    lazy normalization and bins from normalized chunks
    (``binned_from_csr``) — grids and models bit-identical to the dense
    normalize-then-bin pipeline."""
    return bool(args.sparse and args.ranker in _TREE_RANKERS)


def _read_csr_norm_binned(path, args, must_rel, feature_fids,
                          n_features=None, thresholds=None):
    """CSR → lazy norm → bins, for -sparse -norm tree rankers. -qrel is the
    caller's, outside its loader-fallback ``try`` (a qrel problem is a
    real error); it changes labels only, so it commutes with binning."""
    from ranklib_tpu_torch.data.binned import binned_from_csr

    ds = _prepare(path, feature_fids, args.missingZero, must_rel,
                  n_features=n_features, norm=args.norm, sparse=True,
                  want_descs=bool(args.qrel))
    return binned_from_csr(ds, n_threshold=_tc(args), thresholds=thresholds)


def _tc(args) -> int:
    return args.tc if args.tc is not None else 256


def _stream_file(path, args, must_rel, feature_fids, train):
    """A validation or test file of a streamed fit, binned with the
    training grid (-qrel applied)."""
    if args.norm:
        ds = _read_csr_norm_binned(path, args, must_rel, feature_fids,
                                   n_features=train.n_features,
                                   thresholds=train.thresholds)
    else:
        from ranklib_tpu_torch.data.binned import read_letor_binned

        ds = read_letor_binned(path, thresholds=train.thresholds,
                               must_have_rel_doc=must_rel,
                               n_features=train.n_features,
                               missing_zero=args.missingZero,
                               want_descs=bool(args.qrel))
    if args.qrel:
        apply_qrel(ds, args.qrel)
    return ds


def _sparse_train(args, feature_fids, must_rel, split: bool):
    """The -sparse training set of a tree ranker: (train, held-out or
    None, the streamed path's -feature split mask or None), or (None,
    None, None) when the loader does not apply (logged; the caller runs
    the dense pipeline). ``split``: -tts/-tvs, whose grid the dense
    pipeline takes from the training subset, so the file is read as CSR,
    split, and each side binned with the training side's grid."""
    from ranklib_tpu_torch.data.binned import (
        binned_from_csr, read_letor_binned,
    )

    what = ("CSR split-grid loader" if split else
            "CSR-normalized binning" if args.norm else "streaming loader")
    try:
        if split:
            ds = _prepare(args.train, feature_fids, args.missingZero,
                          must_rel, norm=args.norm, sparse=True,
                          want_descs=bool(args.qrel))
        elif args.norm:
            ds = _read_csr_norm_binned(args.train, args, must_rel,
                                       feature_fids)
        else:
            ds = read_letor_binned(
                args.train, n_threshold=_tc(args),
                must_have_rel_doc=must_rel, missing_zero=args.missingZero,
                want_descs=bool(args.qrel))
    except RankLibError as e:
        log(f"[-sparse] {what} not applicable ({e}); "
            f"using the dense pipeline")
        return None, None, None
    if args.qrel:
        apply_qrel(ds, args.qrel)
    if split:
        has_tts = bool(args.tts) and args.tts > 0
        tr_c, held_c = split_tvs(ds, args.tts if has_tts else args.tvs)
        train = binned_from_csr(tr_c, n_threshold=_tc(args))
        return (train, binned_from_csr(held_c, thresholds=train.thresholds),
                None)
    if not args.norm and feature_fids is not None:
        return ds, None, feature_mask_from_fids(feature_fids, ds.n_features)
    return ds, None, None


def evaluate_train(args, device: torch.device) -> Ranker:
    """Flow 3.1: -train (+ -validate or -tvs) (+ -test or -tts) (+ -save)."""
    feature_fids = read_feature_file(args.feature) if args.feature else None
    train_scorer = create_scorer(args.metric2t, gmax=args.gmax)
    test_scorer = (create_scorer(args.metric2T, gmax=args.gmax)
                   if args.metric2T else train_scorer)
    must_rel = train_scorer.needs_rel
    has_tts = bool(args.tts) and args.tts > 0
    tvs_wanted = (not args.validate and not has_tts
                  and bool(args.tvs) and args.tvs > 0)
    train = held = split_test = validation = feature_mask = None
    stream = _sparse_tree(args)
    if stream:
        train, held, feature_mask = _sparse_train(
            args, feature_fids, must_rel, split=has_tts or tvs_wanted)
        stream = train is not None
    if not stream:
        train = _prepare(args.train, feature_fids, args.missingZero,
                         must_rel, norm=args.norm, qrel=args.qrel)
    if has_tts:
        # -tts carves the test set out of the training file; it overrides
        # -tvs and an explicit -test file (ref: Evaluator -tts precedence)
        if held is None:
            train, held = split_tvs(train, args.tts)
        split_test = held
        log(f"Train-test split: {len(train.queries)} / "
            f"{len(split_test.queries)} queries")
    if args.validate:
        validation = (
            _stream_file(args.validate, args, must_rel, feature_fids, train)
            if stream else
            _prepare(args.validate, feature_fids, args.missingZero,
                     must_rel, n_features=train.n_features, norm=args.norm,
                     qrel=args.qrel))
    elif tvs_wanted:
        if held is None:
            train, held = split_tvs(train, args.tvs)
        validation = held
    ranker = train_ranker(args.ranker, train, train_scorer, validation,
                          args.hparams, device, feature_mask=feature_mask)
    m_train, _ = score_dataset(train_scorer, train,
                               ranker.eval_dataset(train, device), device)
    result(f"{train_scorer.name} on training data: {m_train:.4f}")
    if validation is not None:
        m_val, _ = score_dataset(train_scorer, validation,
                                 ranker.eval_dataset(validation, device),
                                 device)
        result(f"{train_scorer.name} on validation data: {m_val:.4f}")
    if args.test or split_test is not None:
        if split_test is not None:
            test = split_test
        elif stream:
            test = _stream_file(args.test, args, False, feature_fids, train)
        else:
            test = _prepare(args.test, feature_fids, args.missingZero,
                            n_features=train.n_features, norm=args.norm,
                            qrel=args.qrel)
        m_test, per_q = score_dataset(test_scorer, test,
                                      ranker.eval_dataset(test, device),
                                      device)
        result(f"{test_scorer.name} on test data: {m_test:.4f}")
        if args.idv:
            write_idv(args.idv, test_scorer, test, per_q)
    if args.save:
        ranker.save(args.save)
    return ranker


def _sparse_kcv_data(args, feature_fids, must_rel):
    """The host CSR of -sparse -kcv with a tree ranker, or None when the
    loader does not apply (logged). Each fold then bins its own training
    rows (:func:`_bin_folds`): per-fold grids, as the dense pipeline and
    the reference's per-fold ranker init take them (ref:
    FeatureManager.java:~200 prepareCV)."""
    try:
        ds = _prepare(args.train, feature_fids, args.missingZero, must_rel,
                      norm=args.norm, sparse=True,
                      want_descs=bool(args.qrel))
    except RankLibError as e:
        log(f"[-sparse] sparse kcv loader not applicable ({e}); "
            f"using the dense pipeline")
        return None
    if args.qrel:
        apply_qrel(ds, args.qrel)
    return ds


def _bin_folds(folds, tc: int):
    """Each CSR fold binned: training rows with their own grid, validation
    and test with the training grid."""
    from ranklib_tpu_torch.data.binned import binned_from_csr

    for tr, va, te in folds:
        tr_b = binned_from_csr(tr, n_threshold=tc)
        yield (tr_b,
               (binned_from_csr(va, thresholds=tr_b.thresholds)
                if va is not None else None),
               binned_from_csr(te, thresholds=tr_b.thresholds))


def evaluate_kcv(args, device: torch.device) -> None:
    """Flow 3.2: -train file -kcv k [-kcvmd dir -kcvmn name]: train and
    score one ranker a fold, save each fold's model, print the summary
    table. With -sparse, tree rankers' folds ride the host CSR, binned a
    fold at a time."""
    feature_fids = read_feature_file(args.feature) if args.feature else None
    train_scorer = create_scorer(args.metric2t, gmax=args.gmax)
    test_scorer = (create_scorer(args.metric2T, gmax=args.gmax)
                   if args.metric2T else train_scorer)
    ds = None
    if _sparse_tree(args):
        ds = _sparse_kcv_data(args, feature_fids, train_scorer.needs_rel)
    fold_binning = ds is not None
    if ds is None:
        ds = _prepare(args.train, feature_fids, args.missingZero,
                      train_scorer.needs_rel, norm=args.norm,
                      qrel=args.qrel)
    folds = prepare_cv(ds, args.kcv, args.tvs if args.tvs else -1.0,
                       lazy=True)       # one fold's copies live at a time
    if fold_binning:
        folds = _bin_folds(folds, _tc(args))
    scores_train, scores_test = [], []
    for fold, (tr, va, te) in enumerate(folds):
        log("")
        log(f"Fold {fold + 1} / {args.kcv}...")
        ranker = train_ranker(args.ranker, tr, train_scorer, va,
                              args.hparams, device)
        m_tr, _ = score_dataset(train_scorer, tr,
                                ranker.eval_dataset(tr, device), device)
        m_te, _ = score_dataset(test_scorer, te,
                                ranker.eval_dataset(te, device), device)
        scores_train.append(m_tr)
        scores_test.append(m_te)
        if args.kcvmd:
            os.makedirs(args.kcvmd, exist_ok=True)
            name = args.kcvmn or "model"
            ranker.save(os.path.join(args.kcvmd, f"f{fold + 1}.{name}"))
    result("")
    result("Summary:")
    result(f"{'Fold':<8}| {train_scorer.name + ' (train)':<16}| "
           f"{test_scorer.name + ' (test)':<16}")
    for i, (a, b) in enumerate(zip(scores_train, scores_test)):
        result(f"Fold {i + 1:<3}| {a:<16.4f}| {b:<16.4f}")
    result(f"{'Avg.':<8}| {np.mean(scores_train):<16.4f}| "
           f"{np.mean(scores_test):<16.4f}")


def _load_model(args) -> Ranker:
    """``-load``'s ranker; with -sparse only tree models are served (host
    CSR scored in bounded dense chunks)."""
    ranker = load_ranker_file(args.load)
    if args.sparse and not hasattr(ranker, "ensemble") and not hasattr(
            ranker, "ensembles"):
        raise RankLibError(
            f"-sparse with a loaded {ranker.NAME} model is not yet ported to "
            f"ranklib_tpu_torch (the raw-value rankers' -sparse; -sparse "
            f"serves MART, LambdaMART and Random Forests models)")
    return ranker


def evaluate_test_only(args, device: torch.device) -> None:
    """Flow 3.3: -load model -test file -metric2T metric [-idv file]."""
    scorer = create_scorer(args.metric2T or args.metric2t, gmax=args.gmax)
    ranker = _load_model(args)
    feature_fids = read_feature_file(args.feature) if args.feature else None
    test = _prepare(args.test, feature_fids, missing_zero=args.missingZero,
                    norm=args.norm, qrel=args.qrel, sparse=args.sparse)
    m, per_q = score_dataset(scorer, test, ranker.eval_dataset(test, device),
                             device)
    result(f"{scorer.name} on test data: {m:.4f}")
    if args.idv:
        write_idv(args.idv, scorer, test, per_q)


def evaluate_rank(args, device: torch.device) -> None:
    """Flow 3.3: -load model -rank file [-score out] [-indri out]."""
    ranker = _load_model(args)
    feature_fids = read_feature_file(args.feature) if args.feature else None
    data = _prepare(args.rank, feature_fids, missing_zero=args.missingZero,
                    norm=args.norm, qrel=args.qrel, sparse=args.sparse,
                    want_descs=bool(args.indri))
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
