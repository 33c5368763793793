"""One boosting round as a plain Python call per tree (ranklib_tpu.gbdt.boost;
ref: LambdaMART.learn, learning/tree/LambdaMART.java:~200).

A round — pseudo-responses, tree growth, leaf outputs, score update,
train/validation metrics, the tree's record — runs entirely on the data's
device and reads nothing back: metric histories and tree records
accumulate in :class:`BoostState` tensors, and only the caller's round
loop (``models.gbdt``) reads them, at its per-round table or early-stop
check. The state updates in place (the reference's is a donated JAX
carry).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ranklib_tpu_torch.data.dataset import Dataset, bucketize, flatten_meta
from ranklib_tpu_torch.gbdt.grow import grow_tree, leaf_outputs
from ranklib_tpu_torch.gbdt.lambdas import (
    SEPARABLE_METRICS, chunk_scale, lambda_fn,
)


def round_capacity(n_trees: int) -> int:
    """Tree-record capacity: a power of two ≥ 128 (the reference's
    compile-shape class, kept so the records have its shapes)."""
    cap = 128
    while cap < n_trees:
        cap *= 2
    return cap


@dataclass
class BoostData:
    """Per-fit device tensors."""

    binned_T: torch.Tensor        # [F, Npad] uint8/int16/int32
    labels_flat: torch.Tensor     # [Npad] f32 (pads 0)
    doc_mask: torch.Tensor        # [Npad] bool
    feat_mask: torch.Tensor       # [F] bool
    tb: list                      # train chunks: (labels, mask, didx)
    vbinned: torch.Tensor | None  # [Nv, F] doc-major (traversal)
    vb: list                      # validation chunks (may be empty)
    tb_scale: list                # per chunk [rows] f32 swap-delta scale
                                  #   of the separable sort-free path
    tb_inv: torch.Tensor          # [Npad] int64: each doc's position in
                                  #   the concatenated chunk layouts (pad
                                  #   docs → a zero tail slot)


@dataclass
class BoostState:
    """Scores, metric histories and tree records (leading dim CAP)."""

    scores: torch.Tensor          # [Npad + 1] f32
    vscores: torch.Tensor         # [Nv + 1] f32 (size 1 without val)
    tfeat: torch.Tensor           # [CAP, M] int32
    tbin: torch.Tensor            # [CAP, M] int32
    tleft: torch.Tensor           # [CAP, M] int32
    tright: torch.Tensor          # [CAP, M] int32
    tleaf: torch.Tensor           # [CAP, M] bool
    tout: torch.Tensor            # [CAP, M] f32
    tnodes: torch.Tensor          # [CAP] int32
    train_m: torch.Tensor         # [CAP] f32 (NaN until written)
    val_m: torch.Tensor           # [CAP] f32
    impacts: torch.Tensor         # [F] f32 cumulative deviance reduction


def make_boost_data(train: Dataset, binned_pad: np.ndarray,
                    labels_pad: np.ndarray, n_real: int,
                    validation: Dataset | None, vbinned: np.ndarray | None,
                    device: torch.device, feature_mask=None,
                    scorer=None):
    """(BoostData, Npad, Nvpad). ``binned_pad``: [Npad, F]. ``scorer``:
    when given and separable, the per-chunk swap scales are computed here,
    once per fit."""
    Npad, F = binned_pad.shape
    tb_host = _host_buckets(train, n_real)
    tb = _upload(tb_host, device)
    vb, Nvpad = [], 0
    if validation is not None:
        Nvpad = vbinned.shape[0]
        vb = _upload(_host_buckets(validation, Nvpad), device)
    tb_scale = []
    if scorer is not None and scorer.metric in SEPARABLE_METRICS:
        tb_scale = [chunk_scale(scorer, lab, msk) for lab, msk, _ in tb]
    # inverse of the chunk layout: position of doc d inside
    # concat(chunk didx.flatten()); pad docs and chunk pad slots resolve to
    # the zero tail slot the round appends. Chunks partition the docs, so
    # one gather replaces a scatter-add per chunk.
    didx_flat = np.concatenate([d.reshape(-1) for _, _, d in tb_host])
    inv = np.full(Npad + 1, len(didx_flat), np.int64)
    real = didx_flat < n_real
    inv[didx_flat[real]] = np.flatnonzero(real)
    mask = (np.ones(F, bool) if feature_mask is None
            else np.asarray(feature_mask, bool))
    return BoostData(
        binned_T=upload_bins(np.ascontiguousarray(binned_pad.T), device),
        labels_flat=torch.from_numpy(labels_pad).to(device),
        doc_mask=torch.from_numpy(np.arange(Npad) < n_real).to(device),
        feat_mask=torch.from_numpy(mask).to(device),
        tb=tb,
        vbinned=(upload_bins(vbinned, device) if vbinned is not None
                 else None),
        vb=vb,
        tb_scale=tb_scale,
        tb_inv=torch.from_numpy(inv[:Npad]).to(device),
    ), Npad, Nvpad


def upload_bins(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A bin matrix on ``device`` at the narrowest width holding it:
    uint8 when every id is < 256, int16 below 32767, else int32. An NaN
    feature at B = 256 bins to 256, so its matrix travels as int16."""
    mx = a.max(initial=0)
    if mx < 256:
        a = a.astype(np.uint8)
    elif mx < np.iinfo(np.int16).max:
        a = a.astype(np.int16)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# max elements of one [Bc, D, D] pair temporary (f32): 2^24 ≈ 64 MB
_PAIR_BUDGET = 1 << 24


def _host_buckets(ds: Dataset, sentinel: int) -> list:
    """Padded (labels, mask, didx) numpy chunks per bucket of the dataset,
    split into row chunks so that no [Bc, D, D] pair temporary of the
    round exceeds the budget. ``didx``: each slot's flat doc index, pad
    slots → ``sentinel``."""
    _, qptr = flatten_meta(ds)
    out = []
    for b in bucketize(ds):
        didx = np.full((b.B, b.D), sentinel, np.int64)
        for row, qi in enumerate(b.qidx):
            s, e = qptr[qi], qptr[qi + 1]
            didx[row, : e - s] = np.arange(s, e)
        rows = max(1, min(b.B, _PAIR_BUDGET // (b.D * b.D)))
        for lo in range(0, b.B, rows):
            hi = min(lo + rows, b.B)
            pad = rows - (hi - lo)
            out.append((np.pad(b.labels[lo:hi], ((0, pad), (0, 0))),
                        np.pad(b.mask[lo:hi], ((0, pad), (0, 0))),
                        np.pad(didx[lo:hi], ((0, pad), (0, 0)),
                               constant_values=sentinel)))
    return out


def _upload(chunks, device) -> list:
    return [tuple(torch.from_numpy(a).to(device) for a in c) for c in chunks]


def _bucket_metric_sum(scorer, buckets, scores_flat):
    total = torch.zeros((), dtype=torch.float32, device=scores_flat.device)
    for lab, msk, didx in buckets:
        sc = scores_flat[didx]
        total = total + scorer.score_from_scores(lab, sc, msk).sum()
    return total


def make_round_step(scorer, *, n_bins: int, n_leaves: int,
                    min_leaf_support: int, learning_rate: float,
                    pointwise: bool, newton: bool, n_queries: int,
                    n_vqueries: int, train_metric: bool = True):
    """The round: ``step(state, t, data) → state``. ``train_metric=False``
    skips the per-round train metric, which only feeds the console
    table. Lambda routing as the reference's (boost.py:223-235) without
    the opt-in fused kernel: sort-free for NDCG/DCG/P, ERR and MAP,
    sorted for RR and BEST."""
    M = 2 * n_leaves - 1
    lr = learning_rate
    lam_fn = lambda_fn(scorer)

    def step(state: BoostState, t: int, data: BoostData) -> BoostState:
        scores = state.scores

        # ---- pseudo-responses ------------------------------------------
        if pointwise:
            lam = torch.where(data.doc_mask,
                              data.labels_flat - scores[:-1], 0.0)
            w = torch.ones_like(lam)
        else:
            scales = data.tb_scale or [None] * len(data.tb)
            parts_l, parts_w = [], []
            for (lab, msk, didx), scl in zip(data.tb, scales):
                l_, w_ = lam_fn(lab, scores[didx], msk, scl)
                parts_l.append(l_.reshape(-1))
                parts_w.append(w_.reshape(-1))
            zero = torch.zeros(1, dtype=scores.dtype, device=scores.device)
            lam = torch.cat(parts_l + [zero])[data.tb_inv]
            w = torch.cat(parts_w + [zero])[data.tb_inv]

        # ---- tree -------------------------------------------------------
        arr = grow_tree(data.binned_T, lam, n_bins=n_bins, n_leaves=n_leaves,
                        min_leaf_support=min_leaf_support,
                        doc_mask=data.doc_mask, feature_mask=data.feat_mask)
        out = leaf_outputs(arr.node_of_doc, lam, w, M, newton,
                           doc_mask=data.doc_mask)
        scores[:-1] += lr * out.index_select(0, arr.node_of_doc)

        # ---- metrics ----------------------------------------------------
        if train_metric:
            state.train_m[t] = (_bucket_metric_sum(scorer, data.tb, scores)
                                / n_queries)
        if data.vb:
            Nv = data.vbinned.shape[0]
            node = torch.zeros(Nv, dtype=torch.int64, device=scores.device)
            for _ in range(n_leaves):        # max depth of a leaf-wise tree
                # leaf slots carry feature −1: clamp so the gather stays
                # in range (the where below keeps leaves where they are)
                f = arr.feature[node].clamp(min=0).long()
                vbin = data.vbinned.gather(1, f[:, None])[:, 0]
                nxt = torch.where(vbin.to(torch.int32) <= arr.bin[node],
                                  arr.left[node], arr.right[node]).long()
                node = torch.where(arr.is_leaf[node], node, nxt)
            state.vscores[:-1] += lr * out[node]
            state.val_m[t] = (_bucket_metric_sum(scorer, data.vb,
                                                 state.vscores) / n_vqueries)

        # ---- record the tree --------------------------------------------
        state.tfeat[t] = arr.feature
        state.tbin[t] = arr.bin
        state.tleft[t] = arr.left
        state.tright[t] = arr.right
        state.tleaf[t] = arr.is_leaf
        state.tout[t] = out
        state.tnodes[t] = arr.n_nodes
        state.impacts += arr.impacts
        return state

    return step


def init_state(n_trees: int, n_leaves: int, Npad: int, Nvpad: int,
               n_features: int, device: torch.device) -> BoostState:
    M = 2 * n_leaves - 1
    CAP = round_capacity(n_trees)
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return BoostState(
        scores=torch.zeros(Npad + 1, **f32),
        vscores=torch.zeros(Nvpad + 1, **f32),
        tfeat=torch.zeros((CAP, M), **i32),
        tbin=torch.zeros((CAP, M), **i32),
        tleft=torch.full((CAP, M), -1, **i32),
        tright=torch.full((CAP, M), -1, **i32),
        tleaf=torch.zeros((CAP, M), dtype=torch.bool, device=device),
        tout=torch.zeros((CAP, M), **f32),
        tnodes=torch.zeros(CAP, **i32),
        train_m=torch.full((CAP,), torch.nan, **f32),
        val_m=torch.full((CAP,), torch.nan, **f32),
        impacts=torch.zeros(n_features, **f32),
    )
