"""RankLib-compatible command line of the port (ranklib_tpu.cli; ref:
eval/Evaluator.java:~100-350).

The argument parser is the reference's, flag for flag. The ported flows::

    python -m ranklib_tpu_torch -train train.txt -ranker 6 \
        -metric2t NDCG@10 [-validate vali.txt | -tvs 0.8] [-tts 0.8] \
        [-test test.txt -metric2T ERR@10 -idv idv.txt] [-feature fids.txt] \
        -tree 1000 -leaf 10 -shrinkage 0.1 -tc 256 -mls 1 -estop 100 \
        -save model.txt
    python -m ranklib_tpu_torch -load model.txt -test test.txt \
        -metric2T NDCG@10 -idv idv.txt
    python -m ranklib_tpu_torch -load model.txt -rank test.txt -score s.txt
    python -m ranklib_tpu_torch -train train.txt -ranker 8 [-rtype 0|6] \
        -bag 300 -srate 1.0 -frate 0.3 -tree 1 -leaf 100 -save rf.txt
    python -m ranklib_tpu_torch -combine models_dir -o combined.txt
    python -m ranklib_tpu_torch -train train.txt [-ranker 4] -norm zscore \
        -r 5 -i 25 -tolerance 0.001 -test test.txt -save ca.txt
    python -m ranklib_tpu_torch -train train.txt -ranker 1 -epoch 100 \
        -layer 1 -node 10 -lr 0.00005 -validate vali.txt -save net.txt
    python -m ranklib_tpu_torch -train train.txt -ranker 6 -kcv 5 \
        -kcvmd models -kcvmn lm
    python -m ranklib_tpu_torch -load model.txt -test test.txt -qrel q.txt
    python -m ranklib_tpu_torch -train wide.txt -ranker 6 -sparse \
        [-norm zscore] [-tvs 0.8 | -tts 0.8 | -kcv 5] -save model.txt
    python -m ranklib_tpu_torch -load model.txt -rank wide.txt -sparse \
        -score s.txt
    python -m ranklib_tpu_torch -ana -all idv_dir -base base.idv -np 10000

Training takes all ten rankers: MART (``-ranker 0``), RankNet (``1``),
RankBoost (``2``), AdaRank (``3``), Coordinate Ascent (``4``, the
default), LambdaRank (``5``), LambdaMART (``6``), ListNet (``7``), Random
Forests (``8``) and Linear Regression (``9``), with ``-norm
sum|zscore|linear``, ``-qrel`` and, for training, ``-kcv`` on every flow.
``-sparse`` serves the tree rankers (``-ranker 0|6|8``) and loaded tree
models; ``-ana`` compares ``-idv`` files with the randomization test.
Flows and flags not ported yet (``-sparse`` for the raw-value rankers 1,
2, 3, 4, 5, 7 and 9 and their models; with ``-train`` also ``-resume``,
``-ckpt``, ``-dp``, ``-eventlog`` and ``-profile``) exit with a clean
error and rc 1 rather than being ignored. Hyperparameter flags of other
rankers are accepted and unused, as in the reference.
"""

from __future__ import annotations

import argparse
import sys

from ranklib_tpu_torch.utils.errors import RankLibError
from ranklib_tpu_torch.utils.logging import log, set_silent


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ranklib_tpu_torch", add_help=True, allow_abbrev=False,
        description="Learning-to-rank engine on PyTorch/CUDA "
                    "(RankLib-compatible CLI)")
    # training flows
    p.add_argument("-train", metavar="file")
    p.add_argument("-ranker", type=int, default=4,
                   help="0:MART 1:RankNet 2:RankBoost 3:AdaRank 4:CoorAscent "
                        "5:LambdaRank 6:LambdaMART 7:ListNet 8:RandomForests "
                        "9:LinearRegression (default 4)")
    p.add_argument("-feature", metavar="file")
    p.add_argument("-metric2t", default="ERR@10",
                   help="train metric (default ERR@10)")
    p.add_argument("-metric2T", default=None, help="test metric")
    p.add_argument("-gmax", type=float, default=4.0)
    p.add_argument("-qrel", metavar="file")
    p.add_argument("-missingZero", action="store_true")
    p.add_argument("-validate", metavar="file")
    p.add_argument("-tvs", type=float, default=-1.0)
    p.add_argument("-tts", type=float, default=-1.0,
                   help="train-test split ratio x: first x of the training "
                        "queries train, the rest test (overrides -tvs and "
                        "an explicit -test file, like the reference)")
    p.add_argument("-test", metavar="file")
    p.add_argument("-norm", choices=["sum", "zscore", "linear"])
    p.add_argument("-sparse", action="store_true",
                   help="memory-lean input for wide/sparse data")
    p.add_argument("-save", metavar="file")
    p.add_argument("-kcv", type=int, default=-1)
    p.add_argument("-kcvmd", metavar="dir")
    p.add_argument("-kcvmn", metavar="name")
    # test / rerank flows
    p.add_argument("-load", metavar="file")
    p.add_argument("-idv", metavar="file")
    p.add_argument("-rank", metavar="file")
    p.add_argument("-score", metavar="file")
    p.add_argument("-indri", metavar="file")
    # misc
    p.add_argument("-silent", action="store_true")
    p.add_argument("-thread", type=int, default=-1,
                   help="accepted for compatibility")
    p.add_argument("-ckpt", type=int, default=None,
                   help="checkpoint the model every N boosting rounds "
                        "(extension; tree rankers)")
    p.add_argument("-resume", metavar="file",
                   help="warm-start tree training from a saved model "
                        "(extension; continues toward -tree total)")
    p.add_argument("-dp", type=int, default=0,
                   help="data-parallel devices for tree-ranker training "
                        "(extension; 0 = single device)")
    p.add_argument("-randomSeed", type=int, default=0)
    p.add_argument("-eventlog", metavar="file",
                   help="structured JSONL event log of training (extension "
                        "over RankLib)")
    p.add_argument("-profile", metavar="dir",
                   help="profiler trace of training (extension)")
    # ranker hyperparameters (None = use ranker default)
    p.add_argument("-epoch", type=int)
    p.add_argument("-layer", type=int)
    p.add_argument("-node", type=int)
    p.add_argument("-lr", type=float)
    p.add_argument("-tree", type=int)
    p.add_argument("-leaf", type=int)
    p.add_argument("-shrinkage", type=float)
    p.add_argument("-tc", type=int)
    p.add_argument("-mls", type=int)
    p.add_argument("-estop", type=int)
    p.add_argument("-round", type=int)
    p.add_argument("-noeq", action="store_true", default=None)
    p.add_argument("-tolerance", type=float)
    p.add_argument("-max", type=int)
    p.add_argument("-r", type=int)
    p.add_argument("-i", type=int)
    p.add_argument("-reg", type=float)
    p.add_argument("-bag", type=int)
    p.add_argument("-srate", type=float)
    p.add_argument("-frate", type=float)
    p.add_argument("-rtype", type=int)
    p.add_argument("-L2", type=float, dest="l2")
    # analyzer mode (ref: eval/Analyzer.java)
    p.add_argument("-ana", action="store_true")
    p.add_argument("-all", metavar="dir")
    p.add_argument("-base", metavar="file")
    p.add_argument("-np", type=int, default=10000, dest="n_permutations")
    # combiner mode (ref: learning/Combiner.java)
    p.add_argument("-combine", metavar="dir")
    p.add_argument("-o", metavar="file", dest="combine_out")
    return p


# (cli flag, ranker ids, attribute) — per-ranker hyperparameter routing,
# the reference's rows less its extensions (-ckpt). As there, -mls
# reaches Random Forests, which has no such hyperparameter and says so.
_HPARAM_ROUTES = [
    ("epoch", {1, 5, 7}, "n_epoch"),
    ("layer", {1, 5}, "n_layers"),
    ("node", {1, 5}, "n_hidden_per_layer"),
    ("lr", {1, 5, 7}, "learning_rate"),
    ("tree", {0, 6, 8}, "n_trees"),
    ("leaf", {0, 6, 8}, "n_leaves"),
    ("shrinkage", {0, 6, 8}, "learning_rate"),
    ("tc", {0, 2, 6, 8}, "n_threshold"),
    ("mls", {0, 6, 8}, "min_leaf_support"),
    ("estop", {0, 6}, "early_stop"),
    ("round", {2, 3}, "n_rounds"),
    ("noeq", {3}, "no_eq"),
    ("tolerance", {3, 4}, "tolerance"),
    ("max", {3}, "max_sel_count"),
    ("r", {4}, "n_restart"),
    ("i", {4}, "n_max_iteration"),
    ("reg", {4}, "reg"),
    ("bag", {8}, "n_bags"),
    ("srate", {8}, "sub_sampling_rate"),
    ("frate", {8}, "feature_sampling_rate"),
    ("rtype", {8}, "ranker_type"),
    ("l2", {9}, "lam"),
]


def collect_hparams(args) -> dict:
    hp = {attr: getattr(args, flag) for flag, rankers, attr in _HPARAM_ROUTES
          if getattr(args, flag) is not None and args.ranker in rankers}
    if args.randomSeed and args.ranker in (1, 4, 5, 7, 8):
        hp.setdefault("seed", args.randomSeed)
    return hp


_NOTHING_TO_DO = ("Nothing to do: give -train, -load -test, -load -rank, "
                  "-ana, or -combine")


def _has_flow(args) -> bool:
    """True when the arguments select one of the reference's flows."""
    return bool(args.ana or args.combine or args.train
                or (args.load and (args.rank or args.test)))


def _unported(args) -> str | None:
    """The first flow or flag the port does not serve yet (a loaded
    model's -sparse is checked when the model is read)."""
    if args.ana or args.combine:
        return None
    from ranklib_tpu_torch.evaluator import _TREE_RANKERS

    if args.train and args.sparse and args.ranker not in _TREE_RANKERS:
        return (f"-sparse with -ranker {args.ranker} (the raw-value "
                f"rankers' -sparse)")
    if args.train:
        for flag in ("resume", "ckpt", "dp", "eventlog", "profile"):
            if getattr(args, flag):
                return f"-{flag}"
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    set_silent(args.silent)
    if not _has_flow(args):
        log(f"Error: {_NOTHING_TO_DO}")
        return 1
    try:
        flag = _unported(args)
        if flag:
            raise RankLibError(f"{flag} is not yet ported to "
                               f"ranklib_tpu_torch (ported: -train, -kcv, "
                               f"-load with -test or -rank, -norm, -qrel, "
                               f"-ana, -combine, and -sparse for -ranker "
                               f"0, 6 and 8)")
        if args.ana and (not args.all or not args.base):
            raise RankLibError("-ana requires -all <dir> and -base <file>")
        if args.combine and not args.ana:
            from ranklib_tpu_torch.combiner import combine

            if not args.combine_out:
                raise RankLibError("-combine requires -o <output model file>")
            combine(args.combine, args.combine_out)
            return 0
        from ranklib_tpu_torch.device import choose_device
        from ranklib_tpu_torch.evaluator import (
            evaluate_kcv, evaluate_rank, evaluate_test_only, evaluate_train,
        )

        device = choose_device()
        args.hparams = collect_hparams(args)
        if args.ana:
            from ranklib_tpu_torch.analyzer import analyze

            analyze(args.all, args.base, args.n_permutations, device)
        elif args.train and args.kcv > 0:
            evaluate_kcv(args, device)
        elif args.train:
            evaluate_train(args, device)
        elif args.rank:
            evaluate_rank(args, device)
        else:
            evaluate_test_only(args, device)
    except (RankLibError, OSError) as e:
        log(f"Error: {e}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
