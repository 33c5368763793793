"""Leaf-wise regression tree growth (ranklib_tpu.gbdt.grow; ref:
learning/tree/RegressionTree.java:~60, FeatureHistogram.findBestSplit:~300).

* Best-first growth: pop the splittable leaf of highest deviance
  (Σg² − S²/c; the root is seeded with +inf so it always pops first) and
  apply its best split, until ``n_leaves`` leaves exist or nothing splits.
* A candidate (feature f, bin b) is valid iff both sides hold at least
  ``min_leaf_support`` docs; the max of S_L²/c_L + S_R²/c_R wins, first
  (feature-major) max on ties.
* Children by subtraction: the right child's histogram is built directly,
  the left one is parent − right (ref: FeatureHistogram
  construct-from-parent/sibling:~150), and both are scanned in ONE call
  that takes the two as a pair (no stacked copy).

The tree lives in ``M = 2·n_leaves − 1`` fixed slots; the last iteration,
whose children can never be popped, is peeled and builds no histograms.
Every decision stays on the tensors' device: the popped leaf, its
validity and its split are device tensors combined with ``torch.where``,
so a round on the card never waits for the host. Arrays update in place
(the reference's are immutable), which keeps one copy of the node
histograms.

Under ``-dp`` each rank grows the tree on its own shard of the documents
with ``group`` (a ``torch.distributed`` process group, the reference's
``axis_name``): the root and right-child histograms and the SQ sums are
summed across the ranks, so every rank takes the same split decisions;
S and C come from the summed histograms, and the left child by
subtraction from the summed parent. Without a group nothing is summed.

:func:`grow_forest` grows the trees of a group of Random-Forests bags in
lockstep (the same rules per bag, a leading [Cb] axis everywhere): one
:func:`histogram_multi` launch per split serves every bag, and builds
only the features each bag samples when given their lists.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ranklib_tpu_torch.ops.histogram import histogram, histogram_multi
from ranklib_tpu_torch.ops.split_scan import best_splits
from ranklib_tpu_torch.utils.trace import span


# this process's collectives under a group, and the bytes they reduced
# (a ``-dp`` rank's ``launch_counts``)
_COLLECTIVES = {"calls": 0, "bytes": 0}


def sum_across(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``'s ranks (the reference's ``psum``), or
    ``x`` itself without a group. Under a group the call counts in
    ``_COLLECTIVES``."""
    if group is not None:
        with span("all_reduce"):
            torch.distributed.all_reduce(x, group=group)
        _COLLECTIVES["calls"] += 1
        _COLLECTIVES["bytes"] += x.numel() * x.element_size()
    return x


class TreeArrays(NamedTuple):
    """One grown tree in flat-slot form. Slot 0 is the root; unused slots
    (growth stopped early) have is_leaf False and left = right = −1."""

    feature: torch.Tensor      # [M] int32 split feature (0-based column)
    bin: torch.Tensor          # [M] int32 split bin (left iff bin_d <= bin)
    left: torch.Tensor         # [M] int32 child slot (−1 on leaves)
    right: torch.Tensor        # [M] int32
    is_leaf: torch.Tensor      # [M] bool
    n_nodes: torch.Tensor      # [] int32 slots in use
    node_of_doc: torch.Tensor  # [N] int32 leaf slot of each training doc
    impacts: torch.Tensor      # [F] f32 deviance reduction per feature


def _upd(arr: torch.Tensor, idx: torch.Tensor, val, valid: torch.Tensor):
    """arr[idx] = val where valid (idx [1] int64, valid [1] bool), in
    place, without reading anything back to the host."""
    old = arr.index_select(0, idx)
    arr.index_copy_(0, idx, torch.where(valid, val, old))


def _deviance(SQ, S, C):
    return torch.where(C > 0, SQ - S * S / torch.clamp(C, min=1.0),
                       -torch.inf)


def grow_tree(binned_T: torch.Tensor, grad: torch.Tensor, n_bins: int,
              n_leaves: int, min_leaf_support: int = 1, doc_mask=None,
              feature_mask=None, group=None) -> TreeArrays:
    """Grow one regression tree on pseudo-responses ``grad [N]`` f32 over
    feature-major bins ``binned_T [F, N]`` (uint8/int16/int32).

    ``doc_mask``: optional [N] bool mask or f32 doc weights; weight 0
    excludes a doc from every histogram and count, integer weights act as
    multiplicities. ``feature_mask``: optional [F] bool; features outside
    it are never split on. ``group``: the ``-dp`` process group whose
    ranks hold the other documents (``node_of_doc`` covers this rank's)."""
    F, N = binned_T.shape
    M = 2 * n_leaves - 1
    B = int(n_bins)
    mls = float(min_leaf_support)
    dev = grad.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)

    with span("grow.root"):
        dw = (torch.ones(N, **f32) if doc_mask is None
              else doc_mask.to(torch.float32))
        root_hist = sum_across(histogram(binned_T, grad, dw, B), group)
        S0 = root_hist[0, :, 0].sum()          # feature 0 bins every doc once
        SQ0 = sum_across((dw * grad * grad).sum(), group)
        C0 = root_hist[0, :, 1].sum()
        g0, f0, b0, ok0 = best_splits(
            root_hist[None], mls,
            None if feature_mask is None else feature_mask[None])

        # no Python scalar is written into a device tensor below: that
        # setitem copies from the host and waits for the device
        root = torch.arange(M, device=dev) == 0
        hist = torch.zeros((M, F, B, 2), **f32)
        hist[0] = root_hist
        stats = torch.zeros((M, 3), **f32)
        stats[0] = torch.stack([S0, SQ0, C0])
        deviance = torch.where(root, torch.inf, -torch.inf)
        best_gain = torch.zeros(M, **f32)
        best_gain[0:1] = g0
        best_f = torch.zeros(M, **i32)
        best_f[0:1] = f0
        best_b = torch.zeros(M, **i32)
        best_b[0:1] = b0
        splittable = torch.zeros(M, dtype=torch.bool, device=dev)
        splittable[0:1] = ok0

        feature = torch.full((M,), -1, **i32)
        sbin = torch.full((M,), -1, **i32)
        left = torch.full((M,), -1, **i32)
        right = torch.full((M,), -1, **i32)
        is_leaf = root.clone()
        node_of_doc = torch.zeros(N, **i32)
        n_nodes = torch.ones(1, **i32)
        impacts = torch.zeros(F, **f32)
        fm2 = None if feature_mask is None else feature_mask.expand(2, F)
        true1 = torch.ones(1, dtype=torch.bool, device=dev)

    for k in range(n_leaves - 1):
        with span("grow.split"):
            build_children = k < n_leaves - 2   # the last one is peeled
            cand = torch.where(is_leaf & splittable, deviance, -torch.inf)
            leaf = torch.argmax(cand).view(1)                  # [1] int64
            valid = cand.index_select(0, leaf) > -torch.inf     # [1] bool
            f_s = best_f.index_select(0, leaf)
            b_s = best_b.index_select(0, leaf)
            st = stats.index_select(0, leaf)[0]                 # S, SQ, C
            # feature impact: the deviance this split removes, (S_L²/c_L +
            # S_R²/c_R) − S²/c (ref: LambdaMART impacts[])
            parent_term = torch.where(
                st[2] > 0, st[0] * st[0] / torch.clamp(st[2], min=1.0), 0.0)
            impacts.index_add_(0, f_s.long(), torch.where(
                valid, best_gain.index_select(0, leaf) - parent_term, 0.0))
            la = n_nodes.long()
            ra = la + 1

            col = binned_T.index_select(0, f_s.long())[0].to(torch.int32)
            in_node = node_of_doc == leaf.to(torch.int32)
            go_left = col <= b_s
            new_assign = torch.where(
                in_node, torch.where(go_left, n_nodes, n_nodes + 1),
                node_of_doc)
            node_of_doc = torch.where(valid, new_assign, node_of_doc)

            if build_children:
                w_r = dw * (in_node & ~go_left & valid)
                hist_r = sum_across(histogram(binned_T, grad, w_r, B), group)
                hist_l = hist.index_select(0, leaf)[0] - hist_r
                # S_r and C_r from the child histogram itself (feature 0 bins
                # every doc exactly once), so the scan's sums and these share
                # their provenance; only SQ needs a pass over the docs
                S_r = hist_r[0, :, 0].sum()
                C_r = hist_r[0, :, 1].sum()
                SQ_r = sum_across((w_r * grad * grad).sum(), group)
                S_l, SQ_l, C_l = st[0] - S_r, st[1] - SQ_r, st[2] - C_r
                g2, f2, b2, ok2 = best_splits(
                    (hist_l[None], hist_r[None]), mls, fm2)
                _upd(hist, la, hist_l[None], valid)
                _upd(hist, ra, hist_r[None], valid)
                _upd(stats, la, torch.stack([S_l, SQ_l, C_l])[None], valid)
                _upd(stats, ra, torch.stack([S_r, SQ_r, C_r])[None], valid)
                _upd(deviance, la, _deviance(SQ_l, S_l, C_l), valid)
                _upd(deviance, ra, _deviance(SQ_r, S_r, C_r), valid)
                for arr, v in ((best_gain, g2), (best_f, f2), (best_b, b2),
                               (splittable, ok2)):
                    _upd(arr, la, v[0:1], valid)
                    _upd(arr, ra, v[1:2], valid)

            _upd(feature, leaf, f_s, valid)
            _upd(sbin, leaf, b_s, valid)
            _upd(left, leaf, n_nodes, valid)
            _upd(right, leaf, n_nodes + 1, valid)
            _upd(is_leaf, leaf, ~true1, valid)
            _upd(is_leaf, la, true1, valid)
            _upd(is_leaf, ra, true1, valid)
            n_nodes = n_nodes + 2 * valid.to(torch.int32)

    return TreeArrays(feature, sbin, left, right, is_leaf, n_nodes[0],
                      node_of_doc, impacts)


def leaf_outputs(node_of_doc: torch.Tensor, lam: torch.Tensor,
                 w: torch.Tensor, n_slots: int, newton: bool,
                 doc_mask=None, group=None) -> torch.Tensor:
    """Per-slot outputs [n_slots] f32: the Newton step Σλ/Σw (LambdaMART,
    ref: LambdaMART.updateTreeOutput:~400) or the mean response Σλ/count
    (MART, ref: learning/tree/MART.java:~15). ``doc_mask``: bool mask or
    f32 weights, as in :func:`grow_tree`. A masked [M, N] sum per channel,
    as the reference does it: deterministic on the card, where an
    index_add over ~19 segments would sum in atomic order. ``group``: the
    two sums are summed across its ranks (one collective)."""
    dw = None if doc_mask is None else doc_mask.to(lam.dtype)
    if dw is not None:
        lam = lam * dw
    if newton:
        s2_src = w if dw is None else w * dw
    else:
        s2_src = torch.ones_like(lam) if dw is None else dw
    onehot = (node_of_doc[None, :] == torch.arange(
        n_slots, dtype=node_of_doc.dtype, device=lam.device)[:, None])
    s1 = torch.where(onehot, lam[None, :], 0.0).sum(dim=1)
    s2 = torch.where(onehot, s2_src[None, :], 0.0).sum(dim=1)
    if group is not None:
        s1, s2 = sum_across(torch.stack([s1, s2]), group)
    return torch.where(s2 > 0, s1 / torch.where(s2 > 0, s2, 1.0), 0.0)


def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[c, idx[c]] for every bag c (arr [Cb, M], idx [Cb] int64)."""
    return arr.gather(1, idx[:, None])[:, 0]


def _put(arr: torch.Tensor, idx: torch.Tensor, val, valid: torch.Tensor):
    """arr[c, idx[c]] = val[c] where valid[c], in place, on the device.
    ``arr`` [Cb, M] or [Cb, M, K] (then ``val`` [Cb, K])."""
    if arr.dim() == 3:
        at = idx[:, None, None].expand(-1, 1, arr.shape[2])
        old = arr.gather(1, at)[:, 0]
        arr.scatter_(1, at, torch.where(valid[:, None], val, old)[:, None])
        return
    arr.scatter_(1, idx[:, None],
                 torch.where(valid, val, _take(arr, idx))[:, None])


def grow_forest(binned_T: torch.Tensor, grads: torch.Tensor, n_bins: int,
                n_leaves: int, min_leaf_support: int = 1, doc_weights=None,
                feature_masks=None, feature_lists=None) -> TreeArrays:
    """Grow ``Cb`` independent regression trees in lockstep on one bin
    matrix (ref ``grow_forest``, grow.py:256): bag c's tree is the one
    :func:`grow_tree` grows on ``grads[c]`` under ``doc_weights[c]`` and
    ``feature_masks[c]``.

    ``grads`` [Cb, N] f32; ``doc_weights`` optional [Cb, N] f32
    multiplicities (0 excludes a doc); ``feature_masks`` optional [Cb, F]
    bool. ``feature_lists`` optional [Cb, Fs] int32, the features each
    mask holds (``ops.histogram.feature_lists``): the histograms then hold
    those features alone, and zeros where the masks discard the scan.
    Returns TreeArrays with a leading [Cb] axis (node_of_doc [Cb, N],
    impacts [Cb, F]).

    As in the reference: node statistics (S, SQ, C) are sums over the doc
    axis, not histogram rows; both children of every bag go through one
    scan of the pair (left ``[Cb, F, B, 2]``, right ``[Cb, F, B, 2]``),
    2·Cb nodes, with no stacked copy; node histograms live in an
    iteration-indexed buffer — iteration k writes its children at rows
    2k+1 and 2k+2 and ``hidx`` maps each bag's slot to its row (rows a
    slot never maps are never read, so the buffer starts uninitialised)."""
    F, N = binned_T.shape
    Cb = grads.shape[0]
    M = 2 * n_leaves - 1
    B = int(n_bins)
    mls = float(min_leaf_support)
    dev = grads.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    cidx = torch.arange(Cb, device=dev)

    with span("grow.root"):
        dw = (torch.ones((Cb, N), **f32) if doc_weights is None
              else doc_weights.to(torch.float32))
        root_hist = histogram_multi(binned_T, grads, dw, B,
                                    features=feature_lists)       # [Cb,F,B,2]
        S0 = (dw * grads).sum(dim=1)
        SQ0 = (dw * grads * grads).sum(dim=1)
        C0 = dw.sum(dim=1)
        g0, f0, b0, ok0 = best_splits(root_hist, mls, feature_masks)

        root = (torch.arange(M, device=dev) == 0).expand(Cb, M)
        hist = torch.empty((Cb, M, F, B, 2), **f32)
        hist[:, 0] = root_hist
        hidx = torch.zeros((Cb, M), **i32)
        stats = torch.zeros((Cb, M, 3), **f32)
        stats[:, 0] = torch.stack([S0, SQ0, C0], dim=1)
        deviance = torch.where(root, torch.inf, -torch.inf)
        best_gain = torch.zeros((Cb, M), **f32)
        best_gain[:, 0] = g0
        best_f = torch.zeros((Cb, M), **i32)
        best_f[:, 0] = f0
        best_b = torch.zeros((Cb, M), **i32)
        best_b[:, 0] = b0
        splittable = torch.zeros((Cb, M), dtype=torch.bool, device=dev)
        splittable[:, 0] = ok0

        feature = torch.full((Cb, M), -1, **i32)
        sbin = torch.full((Cb, M), -1, **i32)
        left = torch.full((Cb, M), -1, **i32)
        right = torch.full((Cb, M), -1, **i32)
        is_leaf = root.clone()
        node_of_doc = torch.zeros((Cb, N), **i32)
        n_nodes = torch.ones(Cb, **i32)
        impacts = torch.zeros((Cb, F), **f32)
        fm2 = (None if feature_masks is None
               else torch.cat([feature_masks, feature_masks]))

    for k in range(n_leaves - 1):
        with span("grow.split"):
            build_children = k < n_leaves - 2   # the last one is peeled
            cand = torch.where(is_leaf & splittable, deviance, -torch.inf)
            leaf = torch.argmax(cand, dim=1)                   # [Cb] int64
            valid = _take(cand, leaf) > -torch.inf
            f_s = _take(best_f, leaf)
            b_s = _take(best_b, leaf)
            pstats = stats.gather(
                1, leaf[:, None, None].expand(-1, 1, 3))[:, 0]
            parent_term = torch.where(
                pstats[:, 2] > 0,
                pstats[:, 0] * pstats[:, 0]
                / torch.clamp(pstats[:, 2], min=1.0),
                0.0)
            # one (bag, feature) cell per bag: no two adds meet
            impacts.view(-1).index_add_(0, cidx * F + f_s.long(), torch.where(
                valid, _take(best_gain, leaf) - parent_term, 0.0))
            la = n_nodes.long()
            ra = la + 1

            col = binned_T.index_select(0, f_s.long()).to(
                torch.int32)                                    # [Cb, N]
            in_node = node_of_doc == leaf[:, None].to(torch.int32)
            go_left = col <= b_s[:, None]
            new_assign = torch.where(
                in_node, torch.where(go_left, n_nodes[:, None],
                                     n_nodes[:, None] + 1), node_of_doc)
            node_of_doc = torch.where(valid[:, None], new_assign, node_of_doc)

            if build_children:
                # right child directly, left by subtraction (parent −
                # sibling)
                w_r = dw * (in_node & ~go_left & valid[:, None])
                hist_r = histogram_multi(binned_T, grads, w_r, B,
                                         features=feature_lists)
                hist_l = hist[cidx, _take(hidx, leaf).long()] - hist_r
                S_r = (w_r * grads).sum(dim=1)
                SQ_r = (w_r * grads * grads).sum(dim=1)
                C_r = w_r.sum(dim=1)
                S_l = pstats[:, 0] - S_r
                SQ_l = pstats[:, 1] - SQ_r
                C_l = pstats[:, 2] - C_r
                g2, f2, b2, ok2 = best_splits((hist_l, hist_r), mls, fm2)
                # unconditional row writes: a row an invalid bag never maps
                # is never read
                hist[:, 2 * k + 1] = hist_l
                hist[:, 2 * k + 2] = hist_r
                _put(hidx, la, 2 * k + 1, valid)
                _put(hidx, ra, 2 * k + 2, valid)
                _put(stats, la, torch.stack([S_l, SQ_l, C_l], dim=1), valid)
                _put(stats, ra, torch.stack([S_r, SQ_r, C_r], dim=1), valid)
                _put(deviance, la, _deviance(SQ_l, S_l, C_l), valid)
                _put(deviance, ra, _deviance(SQ_r, S_r, C_r), valid)
                for arr, v in ((best_gain, g2), (best_f, f2), (best_b, b2),
                               (splittable, ok2)):
                    _put(arr, la, v[:Cb], valid)
                    _put(arr, ra, v[Cb:], valid)

            _put(feature, leaf, f_s, valid)
            _put(sbin, leaf, b_s, valid)
            _put(left, leaf, n_nodes, valid)
            _put(right, leaf, n_nodes + 1, valid)
            _put(is_leaf, leaf, False, valid)
            _put(is_leaf, la, True, valid)
            _put(is_leaf, ra, True, valid)
            n_nodes = n_nodes + 2 * valid.to(torch.int32)

    return TreeArrays(feature, sbin, left, right, is_leaf, n_nodes,
                      node_of_doc, impacts)


# elements of one [bags, M, N] masked temporary of leaf_outputs_forest
_LEAF_BUDGET = 1 << 27


def leaf_outputs_forest(node_of_doc: torch.Tensor, lam: torch.Tensor,
                        w: torch.Tensor, n_slots: int, newton: bool,
                        doc_weights=None) -> torch.Tensor:
    """Per-bag leaf outputs [Cb, n_slots]: :func:`leaf_outputs` with a
    leading [Cb] axis (ref ``leaf_outputs_forest``, grow.py:426, a
    segment sum over Cb·n_slots segments). Masked [bags, M, N] sums over
    as many bags at a time as ``_LEAF_BUDGET`` holds: deterministic on the
    card, where a segment ``index_add_`` sums in atomic order, and never
    the whole [Cb, M, N] (~9 GB at 64 bags of 100 leaves over 180K
    docs)."""
    Cb, N = node_of_doc.shape
    dw = None if doc_weights is None else doc_weights.to(lam.dtype)
    if dw is not None:
        lam = lam * dw
    if newton:
        s2_src = w if dw is None else w * dw
    else:
        s2_src = torch.ones_like(lam) if dw is None else dw
    slots = torch.arange(n_slots, dtype=node_of_doc.dtype,
                         device=lam.device)[None, :, None]
    step = max(1, _LEAF_BUDGET // max(1, n_slots * N))
    s1, s2 = [], []
    for lo in range(0, Cb, step):
        onehot = node_of_doc[lo:lo + step, None, :] == slots
        s1.append(torch.where(onehot, lam[lo:lo + step, None, :], 0.0)
                  .sum(dim=2))
        s2.append(torch.where(onehot, s2_src[lo:lo + step, None, :], 0.0)
                  .sum(dim=2))
    s1, s2 = torch.cat(s1), torch.cat(s2)
    return torch.where(s2 > 0, s1 / torch.where(s2 > 0, s2, 1.0), 0.0)
