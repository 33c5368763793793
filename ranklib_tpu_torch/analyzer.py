"""Analyzer: compare per-query metric files of N runs against a baseline
(ranklib_tpu.analyzer; ref: eval/Analyzer.java:~40; CLI ``-ana -all <dir>
-base <file> [-np <permutations>]``).

Input files are ``-idv`` outputs (``<metric>   <qid>   <value>`` lines plus
an ``all`` summary row). For each run: the overall metric, the change over
the baseline, win/loss counts, a p-value from the randomization test
(``stats.significance``, on the device), and the wins and losses bucketed
by margin — the reference's buckets [0.1, 0.2), [0.2, 0.4), [0.4, 0.6),
[0.6, 0.8), [0.8, 1.0].
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ranklib_tpu_torch.stats.significance import randomization_test
from ranklib_tpu_torch.utils.errors import RankLibError
from ranklib_tpu_torch.utils.logging import log

_BUCKETS = [(0.1, 0.2), (0.2, 0.4), (0.4, 0.6), (0.6, 0.8), (0.8, 1.01)]


def read_idv(path: str) -> dict:
    """qid → metric value (the 'all' summary row is skipped)."""
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 3:
                continue
            _, qid, val = parts
            if qid == "all":
                continue
            try:
                out[qid] = float(val)
            except ValueError:
                # a stray text file whose line has 3 tokens: analyze()
                # skips it on this error
                raise RankLibError(
                    f"Non-numeric value {val!r} in {path}") from None
    if not out:
        raise RankLibError(f"No per-query rows in {path}")
    return out


def analyze(directory: str, base_file: str, n_permutations: int = 10_000,
            device: torch.device | None = None) -> list:
    """Print the comparison of every run file in ``directory`` with
    ``base_file`` and return one dict a run; the p-values are computed on
    ``device`` (default :func:`~ranklib_tpu_torch.device.choose_device`'s)."""
    base = read_idv(base_file)
    base_name = os.path.basename(base_file)
    runs = []
    for name in sorted(os.listdir(directory)):
        path = os.path.join(directory, name)
        if (not os.path.isfile(path)
                or os.path.abspath(path) == os.path.abspath(base_file)):
            continue
        try:
            runs.append((name, read_idv(path)))
        except RankLibError:
            log(f"Skipping {name} (not a per-query metric file)")
    if not runs:
        raise RankLibError(f"No run files found in {directory}")

    qids = sorted(base.keys())
    bvals = np.array([base[q] for q in qids])
    log(f"Overall comparison (baseline: {base_name}, {len(qids)} queries)")
    log("-" * 84)
    log(f"{'System':<24}{'Performance':<14}{'Improvement':<22}"
        f"{'Win':<6}{'Loss':<7}{'p-value'}")
    log(f"{base_name:<24}{bvals.mean():<14.4f}{'[baseline]':<22}")
    results = []
    for name, run in runs:
        missing = [q for q in qids if q not in run]
        if missing:
            raise RankLibError(
                f"{name} is missing {len(missing)} queries vs baseline")
        rvals = np.array([run[q] for q in qids])
        d = rvals - bvals
        win = int((d > 0).sum())
        loss = int((d < 0).sum())
        p = randomization_test(bvals, rvals, n_permutations, device=device)
        delta = rvals.mean() - bvals.mean()
        pct = 100.0 * delta / bvals.mean() if bvals.mean() != 0 else 0.0
        log(f"{name:<24}{rvals.mean():<14.4f}"
            f"{f'{delta:+.4f} ({pct:+.2f}%)':<22}{win:<6}{loss:<7}{p:.4f}")
        results.append({"name": name, "mean": float(rvals.mean()),
                        "delta": float(delta), "win": win, "loss": loss,
                        "p": float(p), "d": d})

    log("")
    log("Detailed break down")
    log("-" * 84)
    # both signs bucketed by |margin|; the last bucket counts through 1.0
    # inclusive (hi = 1.01), so its label is closed: '[0.8,1]'
    hdr = f"{'':<24}" + "".join(
        f"{f'[{lo:g},1]' if hi > 1.0 else f'[{lo:g},{hi:g})':>10}"
        for lo, hi in _BUCKETS)
    log(f"{'(improvements)':<24}")
    log(hdr + f"{'> 0':>8}{'< 0':>8}")
    for r in results:
        d = r["d"]
        wins = "".join(f"{int(((d >= lo) & (d < hi)).sum()):>10}"
                       for lo, hi in _BUCKETS)
        log(f"{r['name']:<24}{wins}{int((d > 0).sum()):>8}"
            f"{int((d < 0).sum()):>8}")
    log(f"{'(degradations)':<24}")
    log(hdr)
    for r in results:
        d = -r["d"]                        # mirror: bucket loss margins
        losses = "".join(f"{int(((d >= lo) & (d < hi)).sum()):>10}"
                         for lo, hi in _BUCKETS)
        log(f"{r['name']:<24}{losses}")
    return results
