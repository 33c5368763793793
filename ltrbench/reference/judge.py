"""The numbers that decide ``correct``: the program's trees, scores and
validation metrics held against this reference, which works every
quantity out again from the generated arrays.

The reference follows the program's own trees (it routes every document
through them) and judges each checked tree on its own sums:

* ``grid_miss``: splits whose threshold is not one of the reference's
  candidate values (exact: 0), so the grid and the bins agree;
* ``split_gap``: :func:`ltrbench.reference.tree.judge` — the program's
  splits and growth order against the best the reference finds in the
  same node, from its own lambdas (or residuals) and histograms;
* ``leaf_err``: the largest gap between a leaf's output and the
  reference's Σλ/Σw (LambdaMART) or Σc·r/Σc (MART residuals), over the
  tree's largest output;
* ``score_err``: the program's training scores against Σ lr·output of
  the leaves the reference routes each document to, over the largest
  score (the score update);
* ``val_err``: the program's validation NDCG@k against the reference's
  NDCG@k of the same trees.

A reading that is not finite (a NaN or an infinite output, score or
metric) is infinitely far off: it fails every limit, and the folds over
trees and rounds keep it (:func:`ltrbench.reference.tree.worst`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ltrbench.reference import grid, sampling, tree
from ltrbench.reference.lambdas import ndcg_lambdas
from ltrbench.reference.metric import mean_ndcg
from ltrbench.reference.tree import worst

F64 = torch.float64


class Context:
    """The generated arrays on ``device``, with the reference's grid and
    bins of the training documents."""

    def __init__(self, train, vali, n_threshold: int, device):
        self.device = device
        self.x = torch.from_numpy(train.feats).to(device)
        self.y = torch.from_numpy(train.labels).to(device)
        self.qptr = torch.from_numpy(train.qptr).to(device)
        self.doc_counts = self.qptr[1:] - self.qptr[:-1]
        self.thr = grid.thresholds(self.x, n_threshold)
        self.bins = grid.bins(self.x, self.thr)
        self.n_bins = max(len(t) for t in self.thr)
        self.vali = vali is not None
        if vali is not None:
            self.xv = torch.from_numpy(vali.feats).to(device)
            self.yv = torch.from_numpy(vali.labels).to(device)
            self.qv = torch.from_numpy(vali.qptr).to(device)

    @property
    def n_features(self) -> int:
        return self.x.shape[1]


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| over max |want|; inf where either is not
    finite."""
    if not want.numel():
        return 0.0
    if not (bool(torch.isfinite(got).all())
            and bool(torch.isfinite(want).all())):
        return math.inf
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    return err / scale if scale > 0 else err


def _worst(a: dict, b: dict) -> dict:
    return {**a, **{k: worst(a.get(k, 0), v) for k, v in b.items()}}


BROKEN = {"split_gap": 1.0, "grid_miss": 1, "leaf_err": 1.0,
          "score_err": 1.0, "val_err": 1.0}


def judge_boost(ctx: Context, out: dict, cfg: dict) -> dict:
    """LambdaMART. ``out``: {"trees": [Tree] in round order, "scores":
    {round: [N] training scores after it}, "val_m": [rounds] validation
    metric, "checked": rounds to judge}."""
    p = cfg["params"]
    lr, k = float(p["learning_rate"]), _cutoff(cfg["metric"])
    N, dev = ctx.x.shape[0], ctx.device
    allf = torch.ones(ctx.n_features, dtype=torch.bool, device=dev)
    ones = torch.ones(N, dtype=F64, device=dev)
    s = torch.zeros(N, dtype=F64, device=dev)
    sv = (torch.zeros(ctx.xv.shape[0], dtype=F64, device=dev)
          if ctx.vali else None)
    nums = {"split_gap": 0.0, "grid_miss": 0, "leaf_err": 0.0,
            "score_err": 0.0, "val_err": 0.0}
    checked = set(out["checked"])
    for u, t in enumerate(out["trees"][:max(checked) + 1]):
        if not tree.well_formed(t, ctx.n_features):
            return dict(BROKEN)
        slot = tree.route(ctx.x, t)
        o = torch.from_numpy(t.output.astype(np.float64)).to(dev)
        if u in checked:
            lam, w = ndcg_lambdas(ctx.y, s, ctx.qptr, k)
            hist, stats = tree.slot_sums(ctx.bins, slot, t, lam, ones,
                                         ctx.n_bins, F64)
            nums = _worst(nums, tree.judge(
                t, hist, stats, ctx.thr, allf,
                float(p["min_leaf_support"]), int(p["n_leaves"])))
            want = tree.leaf_values(slot, lam, w, t.n, F64)
            lf = torch.from_numpy(t.is_leaf).to(dev)
            nums["leaf_err"] = worst(nums["leaf_err"],
                                     _rel(o[lf], want[lf]))
        s = s + lr * o[slot]
        if u in out["scores"]:
            got = torch.from_numpy(np.asarray(out["scores"][u],
                                              np.float64)).to(dev)
            nums["score_err"] = worst(nums["score_err"], _rel(got, s))
        if sv is not None:
            sv = sv + lr * o[tree.route(ctx.xv, t)]
            if u in checked:
                gap = abs(float(out["val_m"][u])
                          - mean_ndcg(ctx.yv, sv, ctx.qv, k))
                nums["val_err"] = worst(nums["val_err"],
                                        gap if math.isfinite(gap)
                                        else math.inf)
    return nums


def judge_forest(ctx: Context, fits: list, cfg: dict, sample: list) -> dict:
    """Random Forests, one tree a bag of MART residuals. ``fits``: per
    fit, [Tree] of every bag; ``sample``: the (fit, bag) pairs to
    judge."""
    p = cfg["params"]
    if int(p["n_trees"]) != 1:
        raise ValueError("the reference judges one tree a bag")
    dev = ctx.device
    bags = sampling.draw_bags(len(ctx.doc_counts), ctx.n_features,
                              int(p["n_bags"]), float(p["sub_sampling_rate"]),
                              float(p["feature_sampling_rate"]),
                              int(p["seed"]))
    nums = {"split_gap": 0.0, "grid_miss": 0, "leaf_err": 0.0}
    r = ctx.y.to(F64)                 # residuals of the first tree
    for fi, b in sample:
        t = fits[fi][b]
        if not tree.well_formed(t, ctx.n_features):
            return {k: BROKEN[k] for k in nums}
        mult, fmask = bags[b]
        c = torch.repeat_interleave(torch.from_numpy(mult).to(dev),
                                    ctx.doc_counts).to(F64)
        slot = tree.route(ctx.x, t)
        hist, stats = tree.slot_sums(ctx.bins, slot, t, r, c, ctx.n_bins,
                                     F64)
        nums = _worst(nums, tree.judge(
            t, hist, stats, ctx.thr, torch.from_numpy(fmask).to(dev), 1.0,
            int(p["n_leaves"])))
        want = tree.leaf_values(slot, c * r, c, t.n, F64)
        lf = torch.from_numpy(t.is_leaf).to(dev)
        o = torch.from_numpy(t.output.astype(np.float64)).to(dev)
        nums["leaf_err"] = worst(nums["leaf_err"], _rel(o[lf], want[lf]))
    return nums


def _cutoff(metric: str) -> int:
    name, _, k = metric.partition("@")
    if name.upper() != "NDCG":
        raise ValueError(f"the reference trains NDCG@k, not {metric}")
    return int(k or 10)
