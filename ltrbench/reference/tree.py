"""Regression trees as RankLib grows them (RegressionTree, FeatureHistogram).

* Best-first growth: split the leaf of highest deviance Σc·g² − S²/C
  among the leaves that have a valid split, until ``n_leaves`` leaves.
* A split (feature f, bin b) sends a document left iff its bin <= b; it
  is valid iff both sides weigh at least ``mls``; the one with the
  largest S_L²/C_L + S_R²/C_R wins (the first, feature-major, on ties).
* The k-th split's children are slots 2k+1 (left) and 2k+2 (right), so
  a tree's slots give the order in which it grew.

S, C and SQ are sums of c·g, c and c·g² over a node's documents, with g
the pseudo-response and c the document's weight (1, or a bag's
multiplicity).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ltrbench.reference.grid import bin_of


@dataclass
class Tree:
    """One tree in slot form (host arrays)."""

    feature: np.ndarray    # [n] int, 0-based column of each split
    threshold: np.ndarray  # [n] float32: left iff value <= threshold
    left: np.ndarray       # [n] int, -1 on leaves
    right: np.ndarray      # [n] int
    is_leaf: np.ndarray    # [n] bool
    output: np.ndarray     # [n] float32 (leaves)

    @property
    def n(self) -> int:
        return len(self.is_leaf)


def well_formed(t: Tree, n_features: int) -> bool:
    """Slot 0 the root, split k's children at slots 2k+1 and 2k+2, every
    slot reached once, leaves without children."""
    n = t.n
    if n < 1 or n % 2 == 0:
        return False
    seen = np.zeros(n, bool)
    seen[0] = True
    for s in range(n):
        if t.is_leaf[s]:
            continue
        k = (int(t.left[s]) - 1) // 2
        if (int(t.left[s]) != 2 * k + 1 or int(t.right[s]) != 2 * k + 2
                or not 0 <= 2 * k + 2 < n or seen[2 * k + 1]
                or not 0 <= int(t.feature[s]) < n_features):
            return False
        seen[2 * k + 1] = seen[2 * k + 2] = True
    return bool(seen.all()) and (n == 1 or not t.is_leaf[0])


def worst(a: float, b: float) -> float:
    """The worse of two readings of a number compared against a limit: a
    reading that is not a number (NaN) counts as infinitely far off."""
    if math.isnan(a) or math.isnan(b):
        return math.inf
    return max(a, b)


def split_order(t: Tree) -> list:
    """The slot split at each growth step, in order."""
    parent = {int(t.left[s]): s for s in range(t.n) if not t.is_leaf[s]}
    return [parent[2 * k + 1] for k in range(t.n // 2)]


def route(x: torch.Tensor, t: Tree) -> torch.Tensor:
    """[N] int64 leaf slot of every row of ``x [N, F]``."""
    dev = x.device
    feat = torch.from_numpy(t.feature.astype(np.int64)).to(dev)
    thr = torch.from_numpy(t.threshold.astype(np.float32)).to(dev)
    left = torch.from_numpy(t.left.astype(np.int64)).to(dev)
    right = torch.from_numpy(t.right.astype(np.int64)).to(dev)
    leaf = torch.from_numpy(t.is_leaf.astype(bool)).to(dev)
    node = torch.zeros(x.shape[0], dtype=torch.int64, device=dev)
    for _ in range(t.n):
        at = ~leaf[node]
        if not bool(at.any()):
            break
        v = x.gather(1, feat[node][:, None].clamp(min=0))[:, 0]
        nxt = torch.where(v <= thr[node], left[node], right[node])
        node = torch.where(at, nxt, node)
    return node


def slot_sums(bins: torch.Tensor, slot: torch.Tensor, t: Tree,
              g: torch.Tensor, c: torch.Tensor, n_bins: int, dtype):
    """(hist [n, F, B, 2], stats [n, 3]) in ``dtype`` of every slot of
    ``t``: the (Σc·g, Σc) histogram of its documents and its (S, SQ, C);
    documents of weight 0 add nothing. ``slot``: each document's leaf."""
    dev = bins.device
    keep = torch.nonzero(c != 0).flatten()
    s, gk, ck = slot[keep], g[keep].to(dtype), c[keep].to(dtype)
    N, F = bins.shape
    B = int(n_bins)
    hist = torch.zeros((t.n * F * B, 2), dtype=dtype, device=dev)
    vals = torch.stack([ck * gk, ck], dim=1)
    step = max(1, (1 << 27) // max(1, len(keep)))
    for lo in range(0, F, step):
        hi = min(F, lo + step)
        f = torch.arange(lo, hi, device=dev)
        ids = ((s[:, None] * F + f[None, :]) * B
               + bins[keep, lo:hi].to(torch.int64)).reshape(-1)
        hist.index_add_(0, ids, vals[:, None, :].expand(-1, hi - lo, 2)
                        .reshape(-1, 2))
    stats = torch.zeros((t.n, 3), dtype=dtype, device=dev)
    stats.index_add_(0, s, torch.stack([ck * gk, ck * gk * gk, ck], dim=1))
    hist = hist.view(t.n, F, B, 2)
    for p in reversed(range(t.n)):
        if not t.is_leaf[p]:
            a, b = int(t.left[p]), int(t.right[p])
            hist[p] = hist[a] + hist[b]
            stats[p] = stats[a] + stats[b]
    return hist, stats


def gains(hist: torch.Tensor, fmask: torch.Tensor, mls: float):
    """[F, B] S_L²/C_L + S_R²/C_R of every candidate split of one node
    (−inf where a side weighs under ``mls`` or the feature is masked)."""
    s_l = torch.cumsum(hist[..., 0], dim=1)
    c_l = torch.cumsum(hist[..., 1], dim=1)
    s_r = s_l[:, -1:] - s_l
    c_r = c_l[:, -1:] - c_l
    ok = (c_l >= mls) & (c_r >= mls) & fmask[:, None]
    one = torch.ones((), dtype=hist.dtype, device=hist.device)
    gain = (s_l * s_l / torch.maximum(c_l, one)
            + s_r * s_r / torch.maximum(c_r, one))
    return torch.where(ok, gain, -torch.inf)


def deviance(st: torch.Tensor) -> torch.Tensor:
    """SQ − S²/C of stats rows (S, SQ, C); −inf where C is 0."""
    S, SQ, C = st[..., 0], st[..., 1], st[..., 2]
    return torch.where(C > 0, SQ - S * S / torch.where(C > 0, C, 1.0),
                       -torch.inf)


def judge(t: Tree, hist, stats, thr: list, fmask: torch.Tensor,
          mls: float, n_leaves: int) -> dict:
    """How far the tree ``t`` (another's) lies from the growth rules, on
    this reference's node sums of its documents:

    * ``split_gap``: the largest, over its splits, of the share of the
      best split's deviance reduction that the tree's split misses, and
      of the share of the largest splittable deviance that the split
      leaf misses (1 for a split that is not valid, or growth that
      stopped while a leaf could split);
    * ``grid_miss``: splits whose threshold is no candidate value.

    Sums that are not finite (a NaN output upstream) give ``split_gap``
    inf."""
    gap, miss = 0.0, 0
    if not (bool(torch.isfinite(hist).all())
            and bool(torch.isfinite(stats).all())):
        gap = math.inf
    g_all = [None] * t.n

    def best(s):
        if g_all[s] is None:
            g_all[s] = float(gains(hist[s], fmask, mls).max())
        return g_all[s]

    leaves = {0}
    dev = deviance(stats).tolist()
    for k, s in enumerate(split_order(t)):
        cand = [v for v in leaves if best(v) > -np.inf]
        if s not in cand:
            gap = worst(gap, 1.0)
            break
        top = max(dev[v] for v in cand)
        if top > 0:
            gap = worst(gap, (top - dev[s]) / top)
        f = int(t.feature[s])
        b, on = bin_of(thr[f], float(t.threshold[s]))
        miss += not on
        g = gains(hist[s], fmask, mls)
        mine = float(g[f, b]) if b >= 0 else -np.inf
        parent = float(stats[s, 0] ** 2 / stats[s, 2]) if stats[s, 2] > 0 \
            else 0.0
        red = best(s) - parent
        if mine == -np.inf:
            gap = worst(gap, 1.0)
        elif red > 0:
            gap = worst(gap, (best(s) - mine) / red)
        leaves.remove(s)
        leaves |= {2 * k + 1, 2 * k + 2}
    if t.n // 2 < n_leaves - 1 and any(best(v) > -np.inf for v in leaves):
        gap = worst(gap, 1.0)
    return {"split_gap": gap, "grid_miss": miss}


def leaf_values(slot: torch.Tensor, num: torch.Tensor, den: torch.Tensor,
                n: int, dtype) -> torch.Tensor:
    """[n] Σnum/Σden over each slot's documents (0 where Σden is 0)."""
    a = torch.zeros(n, dtype=dtype, device=num.device).index_add_(
        0, slot, num.to(dtype))
    b = torch.zeros(n, dtype=dtype, device=num.device).index_add_(
        0, slot, den.to(dtype))
    return torch.where(b > 0, a / torch.where(b > 0, b, 1.0), 0.0)


def grow(bins: torch.Tensor, thr: list, g: torch.Tensor, c: torch.Tensor,
         fmask: torch.Tensor, n_leaves: int, mls: float, n_bins: int,
         dtype) -> tuple:
    """Grow one tree on pseudo-responses ``g`` under weights ``c``, all
    arithmetic in ``dtype``. Returns (Tree without outputs, [N] int64
    leaf slot of every document)."""
    dev = bins.device
    N, F = bins.shape
    B = int(n_bins)
    gd, cd = g.to(dtype), c.to(dtype)

    def node_hist(docs):
        h = torch.zeros((F * B, 2), dtype=dtype, device=dev)
        step = max(1, (1 << 27) // max(1, len(docs)))
        vals = torch.stack([cd[docs] * gd[docs], cd[docs]], dim=1)
        for lo in range(0, F, step):
            hi = min(F, lo + step)
            f = torch.arange(lo, hi, device=dev)
            ids = (f[None, :] * B + bins[docs, lo:hi].to(torch.int64))
            h.index_add_(0, ids.reshape(-1), vals[:, None, :]
                         .expand(-1, hi - lo, 2).reshape(-1, 2))
        st = torch.stack([(cd[docs] * gd[docs]).sum(),
                          (cd[docs] * gd[docs] * gd[docs]).sum(),
                          cd[docs].sum()])
        return h.view(F, B, 2), st

    M = 2 * n_leaves - 1
    feature = np.full(M, -1)
    threshold = np.zeros(M, np.float32)
    left = np.full(M, -1)
    right = np.full(M, -1)
    docs = {0: torch.nonzero(c != 0).flatten()}
    nodes = {0: node_hist(docs[0])}
    n = 1
    while n < M:
        best = None
        for s in docs:
            h, st = nodes[s]
            gs = gains(h, fmask, mls)
            top = gs.max()
            if top == -torch.inf:
                continue
            d = float(deviance(st))
            if best is None or d > best[0]:
                i = int(torch.argmax(gs.reshape(-1)))
                best = (d, s, i // B, i % B)
        if best is None:
            break
        _, s, f, b = best
        go = bins[docs[s], f].to(torch.int64) <= b
        lo_docs, hi_docs = docs[s][go], docs[s][~go]
        feature[s], threshold[s] = f, thr[f][b]
        left[s], right[s] = n, n + 1
        docs[n], docs[n + 1] = lo_docs, hi_docs
        nodes[n], nodes[n + 1] = node_hist(lo_docs), node_hist(hi_docs)
        del docs[s], nodes[s]
        n += 2
    slot = torch.zeros(N, dtype=torch.int64, device=dev)
    for s, d in docs.items():
        slot[d] = s
    is_leaf = np.zeros(n, bool)
    is_leaf[list(docs)] = True
    t = Tree(np.maximum(feature[:n], 0), threshold[:n], left[:n], right[:n],
             is_leaf, np.zeros(n, np.float32))
    return t, slot
