"""The reference's own fits, in any precision: the control puts them in
the program's place in the precision below the configuration's, and the
judge must then find them wrong. Outputs have the form the drivers give
the program's (:mod:`ltrbench.reference.judge`)."""

from __future__ import annotations

import numpy as np
import torch

from ltrbench.reference import sampling, tree
from ltrbench.reference.judge import Context, _cutoff
from ltrbench.reference.lambdas import ndcg_lambdas
from ltrbench.reference.metric import mean_ndcg


def boost(ctx: Context, cfg: dict, n_rounds: int, dtype) -> dict:
    """``n_rounds`` LambdaMART rounds with every sum in ``dtype``."""
    p = cfg["params"]
    lr, k = float(p["learning_rate"]), _cutoff(cfg["metric"])
    dev = ctx.device
    N = ctx.x.shape[0]
    allf = torch.ones(ctx.n_features, dtype=torch.bool, device=dev)
    ones = torch.ones(N, dtype=dtype, device=dev)
    s = torch.zeros(N, dtype=dtype, device=dev)
    sv = (torch.zeros(ctx.xv.shape[0], dtype=dtype, device=dev)
          if ctx.vali else None)
    trees, scores, val_m = [], {}, []
    for u in range(n_rounds):
        lam, w = ndcg_lambdas(ctx.y, s, ctx.qptr, k, dtype)
        t, slot = tree.grow(ctx.bins, ctx.thr, lam, ones, allf,
                            int(p["n_leaves"]), float(p["min_leaf_support"]),
                            ctx.n_bins, dtype)
        o = tree.leaf_values(slot, lam, w, t.n, dtype)
        t.output = o.float().cpu().numpy()
        trees.append(t)
        s = s + lr * o[slot]
        scores[u] = s.float().cpu().numpy()
        if sv is not None:
            sv = sv + lr * o[tree.route(ctx.xv, t)]
            val_m.append(mean_ndcg(ctx.yv, sv, ctx.qv, k, dtype))
    return {"trees": trees, "scores": scores, "val_m": np.asarray(val_m),
            "checked": list(range(n_rounds))}


def forest(ctx: Context, cfg: dict, bag_ids, dtype) -> dict:
    """{bag: Tree} of the bags ``bag_ids``, each one MART tree on the
    labels under its multiplicities, every sum in ``dtype``."""
    p = cfg["params"]
    dev = ctx.device
    bags = sampling.draw_bags(len(ctx.doc_counts), ctx.n_features,
                              int(p["n_bags"]), float(p["sub_sampling_rate"]),
                              float(p["feature_sampling_rate"]),
                              int(p["seed"]))
    out = {}
    r = ctx.y.to(dtype)
    for b in bag_ids:
        mult, fmask = bags[b]
        c = torch.repeat_interleave(torch.from_numpy(mult).to(dev),
                                    ctx.doc_counts).to(dtype)
        t, slot = tree.grow(ctx.bins, ctx.thr, r, c,
                            torch.from_numpy(fmask).to(dev),
                            int(p["n_leaves"]), 1.0, ctx.n_bins, dtype)
        t.output = tree.leaf_values(slot, c * r, c, t.n,
                                    dtype).float().cpu().numpy()
        out[b] = t
    return out
