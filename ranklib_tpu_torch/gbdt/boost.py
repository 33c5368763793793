"""One boosting round as a plain Python call per tree (ranklib_tpu.gbdt.boost;
ref: LambdaMART.learn, learning/tree/LambdaMART.java:~200).

A round — pseudo-responses, tree growth, leaf outputs, score update,
train/validation metrics, the tree's record — runs entirely on the data's
device and reads nothing back: metric histories and tree records
accumulate in :class:`BoostState` tensors, and only the caller's round
loop (``models.gbdt``) reads them, at its per-round table or early-stop
check. The state updates in place (the reference's is a donated JAX
carry). Under ``-dp`` (``gbdt.boost_dist``) each rank runs the same round
on its own shard with ``group``: histograms, node sums, leaf sums and
metric sums are summed across the ranks, so the records and metric
histories are the same on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ranklib_tpu_torch.data.dataset import Dataset, bucketize, flatten_meta
from ranklib_tpu_torch.gbdt.grow import grow_tree, leaf_outputs, sum_across
from ranklib_tpu_torch.gbdt.lambdas import (
    SEPARABLE_METRICS, chunk_scale, lambda_fn,
)
from ranklib_tpu_torch.ops.lambda_kernel import (
    RoundLambdas, chunk_lambdas, lambda_round, round_lambda_data,
    supports_fused,
)
from ranklib_tpu_torch.utils.trace import span


def round_capacity(n_trees: int) -> int:
    """Tree-record capacity: a power of two ≥ 128 (the reference's
    compile-shape class, kept so the records have its shapes)."""
    cap = 128
    while cap < n_trees:
        cap *= 2
    return cap


def run_silent_rounds(step, state, n_rounds: int, *data, block: int = 50):
    """Silent-mode round loop of RankBoost and AdaRank (the reference's
    ``run_silent_blocks``): rounds run back to back, and the device's
    ``active`` flag is read once every ``block`` rounds to stop
    dispatching rounds that can no longer change the model."""
    for t in range(n_rounds):
        state = step(state, t, *data)
        if (t + 1) % block == 0:
            with span("host_read"):
                active = bool(state.active)
            if not active:
                break
    return state


@dataclass
class BoostData:
    """Per-fit device tensors."""

    binned_T: torch.Tensor        # [F, Npad] uint8/int16/int32
    labels_flat: torch.Tensor     # [Npad] f32 (pads 0)
    doc_mask: torch.Tensor        # [Npad] bool, or f32 doc weights (an
                                  #   RF bag's multiplicities, -rtype 6)
    feat_mask: torch.Tensor       # [F] bool
    tb: list                      # train chunks: (labels, mask, didx)
    vbinned: torch.Tensor | None  # [Nv, F] doc-major (traversal)
    vb: list                      # validation chunks (may be empty)
    tb_scale: list                # per chunk [rows] f32 swap-delta scale
                                  #   of the separable sort-free path
    tb_inv: torch.Tensor          # [Npad] int64: each doc's position in
                                  #   the concatenated chunk layouts (pad
                                  #   docs → a zero tail slot)
    fused: RoundLambdas | None = None  # the fused round's per-fit data
                                  #   (RANKLIB_TPU_FUSED_LAMBDA=1 and a
                                  #   separable metric)


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
    once per fit, and under the fused route its per-query factors."""
    Npad, F = binned_pad.shape
    Nvpad = 0 if validation is None else vbinned.shape[0]
    mask = (np.ones(F, bool) if feature_mask is None
            else np.asarray(feature_mask, bool))
    with span("prepare.upload"):
        labels_flat = torch.from_numpy(labels_pad).to(device)
        binned_T = upload_bins(np.ascontiguousarray(binned_pad.T), device)
        doc_mask = torch.from_numpy(np.arange(Npad) < n_real).to(device)
        feat_mask = torch.from_numpy(mask).to(device)
        vbinned_dev = (upload_bins(vbinned, device) if vbinned is not None
                       else None)
    with span("prepare.buckets"):
        tb_host = _host_buckets(train, n_real)
        tb = _upload(tb_host, device)
        vb = ([] if validation is None
              else _upload(_host_buckets(validation, Nvpad), device))
        tb_scale = []
        if scorer is not None and scorer.metric in SEPARABLE_METRICS:
            tb_scale = [chunk_scale(scorer, lab, msk) for lab, msk, _ in tb]
        # inverse of the chunk layout: position of doc d inside
        # concat(chunk didx.flatten()); pad docs and chunk pad slots
        # resolve to the zero tail slot the round appends. Chunks
        # partition the docs, so one gather replaces a scatter-add per
        # chunk. A -dp rank that holds no query has no chunk: all its
        # docs are pads.
        didx_flat = np.concatenate([d.reshape(-1) for _, _, d in tb_host]
                                   + [np.zeros(0, np.int64)])
        inv = np.full(Npad + 1, len(didx_flat), np.int64)
        real = didx_flat < n_real
        inv[didx_flat[real]] = np.flatnonzero(real)
        tb_inv = torch.from_numpy(inv[:Npad]).to(device)
        fused = None
        if scorer is not None and supports_fused(scorer):
            fused = round_lambda_data(scorer, labels_flat,
                                      flatten_meta(train)[1], tb_host, tb,
                                      tb_inv, device)
    return BoostData(
        binned_T=binned_T,
        labels_flat=labels_flat,
        doc_mask=doc_mask,
        feat_mask=feat_mask,
        tb=tb,
        vbinned=vbinned_dev,
        vb=vb,
        tb_scale=tb_scale,
        tb_inv=tb_inv,
        fused=fused,
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


def _host_buckets(ds: Dataset, sentinel: int,
                  qidx_sentinel: int | None = None) -> list:
    """Padded (labels, mask, didx) numpy chunks per bucket of the dataset,
    split into row chunks so that no [Bc, D, D] pair temporary of the
    round exceeds the budget. ``didx``: each slot's flat doc index, pad
    slots → ``sentinel``. With ``qidx_sentinel`` a chunk also carries its
    rows' query indices (pad rows → ``qidx_sentinel``), to scatter
    per-query metrics of flat scores (AdaRank's COO route)."""
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
            chunk = (np.pad(b.labels[lo:hi], ((0, pad), (0, 0))),
                     np.pad(b.mask[lo:hi], ((0, pad), (0, 0))),
                     np.pad(didx[lo:hi], ((0, pad), (0, 0)),
                            constant_values=sentinel))
            if qidx_sentinel is not None:
                chunk += (np.pad(b.qidx[lo:hi].astype(np.int64), (0, pad),
                                 constant_values=qidx_sentinel),)
            out.append(chunk)
    return out


def _upload(chunks, device) -> list:
    return [tuple(torch.from_numpy(a).to(device) for a in c) for c in chunks]


def _bucket_metric_sum(scorer, buckets, scores_flat, group=None):
    total = torch.zeros((), dtype=torch.float32, device=scores_flat.device)
    for lab, msk, didx in buckets:
        sc = scores_flat[didx]
        total = total + scorer.score_from_scores(lab, sc, msk).sum()
    return sum_across(total, group)


def make_round_step(scorer, *, n_bins: int, n_leaves: int,
                    min_leaf_support: int, learning_rate: float,
                    pointwise: bool, newton: bool, n_queries: int,
                    n_vqueries: int, train_metric: bool = True,
                    group=None):
    """The round: ``step(state, t, data) → state``. ``train_metric=False``
    skips the per-round train metric, which only feeds the console
    table. ``group``: the ``-dp`` process group (``n_queries`` and
    ``n_vqueries`` then count every rank's queries). Lambda routing as the
    reference's (boost.py:223-235): the fused kernel under
    ``RANKLIB_TPU_FUSED_LAMBDA=1`` for NDCG/DCG/P, one launch a round over
    every query (:func:`lambda_round`, on the ``data.fused`` that
    ``make_boost_data`` builds then), else, one bucket chunk at a
    time, :func:`lambda_fn`'s: sort-free for NDCG/DCG/P, ERR and MAP,
    sorted for RR and BEST."""
    M = 2 * n_leaves - 1
    lr = learning_rate
    lam_fn = lambda_fn(scorer)

    def step(state: BoostState, t: int, data: BoostData) -> BoostState:
        with span("step"):
            return _round(state, t, data)

    def _round(state: BoostState, t: int, data: BoostData) -> BoostState:
        scores = state.scores

        # ---- pseudo-responses ------------------------------------------
        with span("round.lambdas"):
            if pointwise:
                lam = torch.where(data.doc_mask > 0,
                                  data.labels_flat - scores[:-1], 0.0)
                w = torch.ones_like(lam)
            elif data.fused is not None:
                lam, w = lambda_round(data.fused, scores)
            else:
                lam, w = chunk_lambdas(lam_fn, data.tb,
                                       data.tb_scale or [None] * len(data.tb),
                                       scores, data.tb_inv)

        # ---- tree -------------------------------------------------------
        with span("round.grow"):
            arr = grow_tree(data.binned_T, lam, n_bins=n_bins,
                            n_leaves=n_leaves,
                            min_leaf_support=min_leaf_support,
                            doc_mask=data.doc_mask,
                            feature_mask=data.feat_mask, group=group)
        with span("round.leaf_outputs"):
            out = leaf_outputs(arr.node_of_doc, lam, w, M, newton,
                               doc_mask=data.doc_mask, group=group)
        with span("round.score_update"):
            scores[:-1] += lr * out.index_select(0, arr.node_of_doc)

        # ---- metrics ----------------------------------------------------
        if train_metric:
            with span("round.train_metric"):
                state.train_m[t] = (_bucket_metric_sum(scorer, data.tb,
                                                       scores, group)
                                    / n_queries)
        # with validation: a -dp rank whose shard drew no validation query
        # still takes part in the sum
        if data.vbinned is not None:
            with span("round.validate"):
                Nv = data.vbinned.shape[0]
                node = torch.zeros(Nv, dtype=torch.int64,
                                   device=scores.device)
                for _ in range(n_leaves):    # max depth of a leaf-wise tree
                    # leaf slots carry feature −1: clamp so the gather
                    # stays in range (the where below keeps leaves where
                    # they are)
                    f = arr.feature[node].clamp(min=0).long()
                    vbin = data.vbinned.gather(1, f[:, None])[:, 0]
                    nxt = torch.where(vbin.to(torch.int32) <= arr.bin[node],
                                      arr.left[node], arr.right[node]).long()
                    node = torch.where(arr.is_leaf[node], node, nxt)
                state.vscores[:-1] += lr * out[node]
                state.val_m[t] = (_bucket_metric_sum(scorer, data.vb,
                                                     state.vscores, group)
                                  / n_vqueries)

        # ---- record the tree --------------------------------------------
        with span("round.record"):
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
