"""Standalone data-prep tool (copy of ranklib_tpu.features_tool): shuffle and
k-fold partitioning of LETOR files.

The reference ships this as a separate main class
(``ciir.umass.edu.features.FeatureManager.main``, features/FeatureManager.java:~30):

    java -cp RankLib.jar ciir.umass.edu.features.FeatureManager \
        -input <file> -output <dir> [-shuffle] [-k <fold> [-tvs <x>]]

* ``-shuffle`` writes ``<basename>.shuffled`` with the order of ranked
  lists (query groups) randomized;
* ``-k N`` writes ``f<i>.train.<basename>`` / ``f<i>.test.<basename>``
  for folds i = 1..N (query j is in test fold ``j % N``, the same
  deterministic round-robin as prepareCV / data/cv.py);
* ``-tvs x`` additionally carves ``f<i>.validation.<basename>`` off the
  tail of each fold's training queries (x = train fraction, matching
  Evaluator's -tvs);
* shuffle-then-partition when both are given (reference NOTE in its
  usage text).

Unlike the reference (which re-serializes parsed DataPoints), this tool
works on RAW LINE GROUPS — each query's lines are carried byte-for-byte
into the output files (descriptions, float formatting, feature order all
preserved). Parsing is only used to validate and group; semantics are
otherwise identical. ``-seed`` pins the shuffle RNG (the reference uses an
unseeded ``Random`` — irreproducible; a flag is strictly better).

Run as ``python -m ranklib_tpu_torch.features_tool <params>``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ranklib_tpu_torch.utils.errors import RankLibError
from ranklib_tpu_torch.utils.io import open_text
from ranklib_tpu_torch.utils.logging import log


def read_query_groups(path: str) -> list[tuple[str, list[str]]]:
    """Group a LETOR file's data lines by consecutive qid, keeping lines
    verbatim. Blank lines and full-line comments are dropped (they carry
    no per-query meaning once groups are reordered)."""
    groups: list[tuple[str, list[str]]] = []
    cur_qid = None
    cur: list[str] = []
    with open_text(path) as f:
        for line in f:
            line = line.rstrip("\n").rstrip("\r")
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            toks = s.split(None, 2)
            if len(toks) < 2 or not toks[1].startswith("qid:"):
                raise RankLibError(f"Missing qid in line: {line!r}")
            qid = toks[1][4:]
            if qid != cur_qid:
                cur = []
                groups.append((qid, cur))
                cur_qid = qid
            cur.append(line)
    if not groups:
        raise RankLibError(f"No queries read from {path}")
    return groups


def _write_groups(groups, path: str) -> None:
    with open(path, "w") as f:
        for _, lines in groups:
            for line in lines:
                f.write(line + "\n")
    log(f"... Saved {len(groups)} ranked lists to [{path}]")


def shuffle_file(input_path: str, output_dir: str,
                 seed: int | None = None) -> str:
    """Write ``<basename>.shuffled`` with randomized query order; returns
    the output path (ref: FeatureManager -shuffle)."""
    groups = read_query_groups(input_path)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(groups))
    out = os.path.join(output_dir, os.path.basename(input_path) + ".shuffled")
    _write_groups([groups[i] for i in order], out)
    return out


def prepare_cv_files(input_path: str, output_dir: str, n_fold: int,
                     tvs: float = -1.0,
                     groups: list[tuple[str, list[str]]] | None = None,
                     basename: str | None = None) -> list[tuple[str, ...]]:
    """Write per-fold train/test(/validation) LETOR files; returns the
    list of written path tuples (ref: FeatureManager -k / -tvs; fold
    assignment matches data/cv.py prepare_cv: query i tests in fold i%k)."""
    if groups is None:
        groups = read_query_groups(input_path)
    if n_fold < 2:
        raise RankLibError(f"Need at least 2 folds, got {n_fold}")
    if len(groups) < n_fold:
        raise RankLibError(
            f"Cannot make {n_fold} folds from {len(groups)} queries")
    base = basename or os.path.basename(input_path)
    fold_test = [[] for _ in range(n_fold)]
    for i, g in enumerate(groups):
        fold_test[i % n_fold].append(g)
    written = []
    for f in range(n_fold):
        train = [g for j in range(n_fold) if j != f for g in fold_test[j]]
        valid = None
        if tvs and tvs > 0:
            n_train = int(len(train) * tvs)
            if n_train < 1 or n_train >= len(train):
                raise RankLibError(
                    f"-tvs {tvs} leaves an empty train or validation split")
            valid = train[n_train:]
            train = train[:n_train]
        paths = (os.path.join(output_dir, f"f{f + 1}.train.{base}"),
                 os.path.join(output_dir, f"f{f + 1}.test.{base}"))
        _write_groups(train, paths[0])
        _write_groups(fold_test[f], paths[1])
        if valid is not None:
            vp = os.path.join(output_dir, f"f{f + 1}.validation.{base}")
            _write_groups(valid, vp)
            paths = paths + (vp,)
        written.append(paths)
    return written


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ranklib_tpu_torch.features_tool", add_help=False,
        description="Shuffle / k-fold partition a LETOR feature file "
                    "(reference: ciir.umass.edu.features.FeatureManager)")
    p.add_argument("-input", required=True, metavar="file")
    p.add_argument("-output", required=True, metavar="dir")
    p.add_argument("-shuffle", action="store_true")
    p.add_argument("-k", type=int, default=-1, metavar="fold")
    p.add_argument("-tvs", type=float, default=-1.0, metavar="x")
    p.add_argument("-seed", type=int, default=None)
    p.add_argument("-h", "--help", action="help")
    a = p.parse_args(argv)

    if not a.shuffle and a.k <= 0:
        p.error("nothing to do: give -shuffle and/or -k <fold>")
    try:
        os.makedirs(a.output, exist_ok=True)
        groups = None
        basename = os.path.basename(a.input)
        if a.shuffle:
            out = shuffle_file(a.input, a.output, seed=a.seed)
            groups = read_query_groups(out)   # partition the shuffled copy
            basename = os.path.basename(out)
        if a.k > 0:
            prepare_cv_files(a.input, a.output, a.k, tvs=a.tvs,
                             groups=groups, basename=basename)
    except RankLibError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
