"""Neural rankers: RankNet (`-ranker 1`), LambdaRank (`-ranker 5`), ListNet
(`-ranker 7`) (ranklib_tpu.models.neural; ref: learning/neuralnet/
{RankNet,LambdaRank,ListNet}.java).

An MLP with logistic transfer on every layer, the output included,
trained by one SGD step per query (the query is the minibatch):

* RankNet: Σ softplus(−(s_i − s_j)) over pairs with label_i > label_j
  (default 1 hidden layer x 10, lr 5e-5, 100 epochs);
* LambdaRank: the same, each pair weighted by |Δmetric| of swapping it in
  the current ranking (``ops.sorting.rank_perm`` and
  ``MetricScorer.swap_deltas``, recomputed every step);
* ListNet: no hidden layer, top-one cross-entropy against
  softmax(labels) (lr 1e-5, 1,500 epochs).

Queries are visited as the reference's scan visits them: buckets smallest
padded size first, file order inside a bucket. A step trims its query to
its real documents and derives the gradient by hand (dL/ds per loss, then
backprop through the sigmoids with h(1 − h)); no autograd graph is built.
Products run in full f32. An epoch ends with the mis-ordered pair count
(console only) and the validation metric with the best-on-validation
snapshot (strict >, from −inf), all on the device: the host reads back
only on the epochs the console prints.

A ``-sparse`` CSR file under the device budget trains from its dense
buckets, materialized in bounded chunks (the same steps as the dense
file's). Above it (``ops.sparse_eval.wants_sparse_eval``) the first
layer is sparse: a query's step gathers ``W1`` rows by fid and sums each
document's run of entries (``x @ W1`` without ``[n, F]``), and its
gradient is ``vals · δh`` summed per fid, in fid order, into the rows it
touches (dW1), and ``Σ δh`` (db1); both sums are ordered, so two fits on
the card are bit-identical. The epoch's pair count and validation score
every document through the COO layer.

Initial weights are U(−0.05, 0.05) from a ``torch.Generator`` seeded with
``-randomSeed`` on the CPU, so the card and the CPU start alike; the
reference draws from ``jax.random``, so the same seed gives other initial
weights in the two packages (tests inject the reference's draws).

Under ``-dp`` (``mesh``, ``parallel.dp``) the ranks hold their shards of
the queries, dealt within each padded size class, every class with the
same row count on every rank, and step in lockstep: the r-th step of a
class takes each rank's r-th query of that class (a rank without one
contributes zeros), the step's gradients are summed across the ranks in
one ``all_reduce`` of one flat buffer, and every rank applies the same
update. So ``-dp n`` trains a synchronous minibatch of n queries a step,
the gradient summed, not averaged: the reference's documented departure
from sequential SGD, identical at n = 1. The epoch's pair count and
validation sum are summed too, so the best-on-validation snapshot is the
same on every rank. The parent draws the initial weights. A sparse first
layer (above the device budget) is single-device: ``-dp`` then logs the
reference's line and fits on one device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ranklib_tpu_torch.data.dataset import Dataset, iter_buckets, query_feats
from ranklib_tpu_torch.device import choose_device
from ranklib_tpu_torch.gbdt.grow import sum_across
from ranklib_tpu_torch.metrics.base import MetricScorer
from ranklib_tpu_torch.models.base import (
    Ranker, model_header, parse_model_params, register_ranker,
)
from ranklib_tpu_torch.ops.batched_eval import (
    device_class_buckets, full_f32_products,
)
from ranklib_tpu_torch.ops.sorting import rank_perm
from ranklib_tpu_torch.ops.sparse_eval import (
    build_sparse_data, sparse_scores_flat, wants_sparse_eval,
)
from ranklib_tpu_torch.utils.errors import RankLibError
from ranklib_tpu_torch.utils.logging import event, is_silent, log


def _init_params(generator: torch.Generator, layer_sizes) -> list:
    """[(W [in, out], b [out])] f32 CPU tensors drawn U(−0.05, 0.05)."""
    return [(torch.empty(fan_in, fan_out).uniform_(-0.05, 0.05,
                                                   generator=generator),
             torch.empty(fan_out).uniform_(-0.05, 0.05, generator=generator))
            for fan_in, fan_out in zip(layer_sizes[:-1], layer_sizes[1:])]


def _forward(params, x: torch.Tensor) -> torch.Tensor:
    """x [..., F] → scores [...]; logistic transfer on every layer."""
    h = x
    for W, b in params:
        h = torch.sigmoid(torch.matmul(h, W) + b)
    return h[..., 0]


def _dloss_ds(loss: str, s, labels, aux, scorer: MetricScorer):
    """dL/ds [n] of one query's loss at its scores ``s [n]``."""
    if loss == "listnet":
        return torch.softmax(s, 0) - aux               # aux: softmax(labels)
    pm = labels[:, None] > labels[None, :]             # i beats j
    rho = torch.sigmoid(s[None, :] - s[:, None])       # σ(−(s_i − s_j))
    if loss == "lambdarank":
        mask_row, n = aux
        perm = rank_perm(s[None, :], mask_row)[0]
        inv = torch.argsort(perm)                      # doc → position
        d = scorer.swap_deltas(labels[perm][None, :], n)[0]
        rho = rho * d[inv[:, None], inv[None, :]].abs()
    G = torch.where(pm, rho, 0.0)
    return G.sum(0) - G.sum(1)


@dataclass
class SparseRows:
    """One query's documents as COO, for the sparse first layer: its
    entries in document order (``fids``, ``vals``, ``docpos``) with each
    document's run length (``doc_len``), and the same entries in fid order
    (``by_fid``) as runs of the distinct fids ``ufid`` (``fid_len``)."""

    fids: torch.Tensor           # [E] int64
    vals: torch.Tensor           # [E] f32
    docpos: torch.Tensor         # [E] int64
    doc_len: torch.Tensor        # [n] int64
    by_fid: torch.Tensor         # [E] int64, a stable argsort of fids
    ufid: torch.Tensor           # [U] int64
    fid_len: torch.Tensor        # [U] int64


def sparse_rows(X: np.ndarray, device) -> SparseRows:
    """:class:`SparseRows` of a query's materialized ``[n, F]`` block."""
    r, f = np.nonzero(X)
    by_fid = np.argsort(f, kind="stable")
    ufid, fid_len = np.unique(f, return_counts=True)
    arrs = (f, X[r, f].astype(np.float32), r,
            np.bincount(r, minlength=X.shape[0]), by_fid, ufid, fid_len)
    return SparseRows(*(torch.from_numpy(np.ascontiguousarray(
        a if a.dtype == np.float32 else a.astype(np.int64))).to(device)
        for a in arrs))


def _first_layer(W, b, x) -> torch.Tensor:
    """σ(x @ W + b) of a dense ``[n, F]`` block or :class:`SparseRows`."""
    if isinstance(x, SparseRows):
        pre = torch.segment_reduce(W.index_select(0, x.fids)
                                   * x.vals[:, None], "sum",
                                   lengths=x.doc_len, axis=0, unsafe=True)
        return torch.sigmoid(pre + b)
    return torch.sigmoid(torch.addmm(b, x, W))


def query_grads(params, row, loss: str, scorer: MetricScorer):
    """(the gradients ``[dW1, db1, dW2, ...]`` of one query's loss at
    ``params``, the first layer's δ ``[n, H]``); ``row`` = (x [n, F] or
    :class:`SparseRows`, labels [n], aux) of its real documents. A sparse
    first layer's dW1 is None: :func:`query_step` adds it from δ into the
    rows it touches."""
    x, labels, aux = row
    hs = [x, _first_layer(*params[0], x)]
    for W, b in params[1:]:
        hs.append(torch.sigmoid(torch.addmm(b, hs[-1], W)))
    g = _dloss_ds(loss, hs[-1][:, 0], labels, aux, scorer)
    delta = g[:, None] * hs[-1] * (1.0 - hs[-1])
    grads = [None] * (2 * len(params))
    for li in range(len(params) - 1, -1, -1):
        if li or not isinstance(x, SparseRows):
            grads[2 * li] = hs[li].T @ delta
        grads[2 * li + 1] = delta.sum(0)
        if li:
            delta = (delta @ params[li][0].T) * hs[li] * (1.0 - hs[li])
    return grads, delta


def query_step(params, row, loss: str, scorer: MetricScorer,
               lr: float) -> None:
    """One SGD step on one query, in place on ``params`` ([W, b] lists):
    ``row`` = (x [n, F] or :class:`SparseRows`, labels [n], aux) of its
    real documents."""
    x = row[0]
    grads, delta = query_grads(params, row, loss, scorer)
    if grads[0] is None:
        # dW1 = Σ vals·δh[docpos] into rows fids, each fid's run in order
        part = (x.vals[:, None] * delta.index_select(0, x.docpos)
                ).index_select(0, x.by_fid)
        dW1 = torch.segment_reduce(part, "sum", lengths=x.fid_len, axis=0,
                                   unsafe=True)
        params[0][0].index_add_(0, x.ufid, dW1, alpha=-lr)
        torch._foreach_add_([t for p in params for t in p][1:], grads[1:],
                            alpha=-lr)
    else:
        torch._foreach_add_([t for p in params for t in p], grads,
                            alpha=-lr)


@dataclass
class NNState:
    """The fit's carry, all on the device."""

    params: list                 # [[W, b], ...], updated in place
    best_params: list            # snapshot of the best-on-validation epoch
    best_val: torch.Tensor       # []
    val_m: torch.Tensor          # [n_epoch] validation metric per epoch
    mis: torch.Tensor            # [n_epoch] mis-ordered pairs (console)


class ScoredBuckets:
    """A dataset's documents for the epoch's pair count and validation:
    ``scores(params)`` yields (scores [B, D], labels, mask) a bucket: of
    ``feats_buckets``, padded (feats, labels, mask) blocks, or of ``coo``
    = (chunks, metric buckets, N) of ``ops.sparse_eval.build_sparse_data``
    through the COO layer."""

    def __init__(self, feats_buckets=None, coo=None):
        self.dense = feats_buckets
        self.coo = coo

    def scores(self, params):
        if self.coo is None:
            for feats, labels, mask in self.dense:
                yield _forward(params, feats), labels, mask
            return
        chunks, buckets, N = self.coo
        W1, b1 = params[0]
        h = torch.sigmoid(sparse_scores_flat(W1, chunks, N) + b1)
        for W, b in params[1:]:
            h = torch.sigmoid(torch.addmm(b, h, W))
        flat = h[:, 0]
        for labels, mask, didx in buckets:
            yield flat[didx], labels, mask


@dataclass
class TrainData:
    """``rows``: one (x, labels, aux) per query with documents, in visit
    order; ``buckets``: its :class:`ScoredBuckets`."""

    rows: list
    buckets: ScoredBuckets


def _aux(loss: str, labels, mask, r: int, n: int, n_docs):
    """What a query's loss needs besides its scores: ListNet's target
    softmax(labels) (over the padded row, as the dense bucket takes it);
    LambdaRank's all-real mask row and doc count."""
    if loss == "listnet":
        return torch.softmax(torch.where(mask[r:r + 1], labels[r:r + 1],
                                         -1e30), dim=1)[0, :n]
    if loss == "lambdarank":
        return mask[r:r + 1, :n], n_docs[r:r + 1]
    return None


def train_rows(ds: Dataset, loss: str, device) -> TrainData:
    """Upload the training buckets and cut one row a query: views of its
    real documents, plus what its loss needs besides (:func:`_aux`)."""
    rows, buckets = [], []
    for feats, labels, mask, qidx in device_class_buckets(ds, device):
        buckets.append((feats, labels, mask))
        n_docs = mask.sum(dim=1, dtype=torch.int32)
        for r, qi in enumerate(qidx):
            n = ds.queries[qi].n
            if n == 0:                   # no real document: no step
                continue
            rows.append((feats[r, :n], labels[r, :n],
                         _aux(loss, labels, mask, r, n, n_docs)))
    return TrainData(rows, ScoredBuckets(buckets))


def shard_train_rows(ds: Dataset, loss: str, device, rank: int,
                     n_ranks: int) -> TrainData:
    """:func:`train_rows` of a ``-dp`` rank (``parallel.dp``): its lockstep
    slots, class by class, each its query's row or None past its queries
    of the class."""
    from ranklib_tpu_torch.parallel.dp import shard_feat_buckets

    chunks, _, per_dev = shard_feat_buckets(ds, n_ranks, rank, device)
    rows = []
    for feats, labels, mask in chunks:
        D = labels.shape[1]
        mine = [qi for Dq, qi in per_dev[rank] if Dq == D]
        n_docs = mask.sum(dim=1, dtype=torch.int32)
        for r in range(labels.shape[0]):
            n = ds.queries[mine[r]].n if r < len(mine) else 0
            rows.append((feats[r, :n], labels[r, :n],
                         _aux(loss, labels, mask, r, n, n_docs))
                        if n else None)
    return TrainData(rows, ScoredBuckets(chunks))


def sparse_train_rows(ds: Dataset, loss: str, device) -> TrainData:
    """:func:`train_rows` for the sparse first layer (ref:
    ``_sparse_query_buckets``): the same queries in the same order, each
    row's x a :class:`SparseRows` of its materialized block, so lazy
    ``-norm``, width clipping and a line's last duplicate fid are the
    dense pipeline's; the documents scored through the COO layer."""
    rows = []
    for b in iter_buckets(ds):
        labels = torch.from_numpy(b.labels).to(device)
        mask = torch.from_numpy(b.mask).to(device)
        n_docs = mask.sum(dim=1, dtype=torch.int32)
        for r, qi in enumerate(b.qidx):
            n = ds.queries[qi].n
            if n == 0:
                continue
            rows.append((sparse_rows(query_feats(ds, qi), device),
                         labels[r, :n],
                         _aux(loss, labels, mask, r, n, n_docs)))
    return TrainData(rows, ScoredBuckets(coo=build_sparse_data(ds, device)))


def lockstep_step(params, row, loss: str, scorer: MetricScorer, lr: float,
                  group) -> None:
    """One ``-dp`` step: this rank's query's gradients (zeros without a
    query, ``row`` None) summed across ``group`` in one ``all_reduce`` of
    one flat buffer, the same update applied on every rank."""
    flat = [t for p in params for t in p]
    if row is None:
        buf = torch.zeros(sum(t.numel() for t in flat),
                          dtype=torch.float32, device=flat[0].device)
    else:
        buf = torch.cat([g.reshape(-1)
                         for g in query_grads(params, row, loss, scorer)[0]])
    torch.distributed.all_reduce(buf, group=group)
    torch._foreach_add_(flat, [g.view(t.shape) for g, t in zip(
        buf.split([t.numel() for t in flat]), flat)], alpha=-lr)


def make_epoch_step(loss: str, scorer: MetricScorer, lr: float,
                    n_val_q: int, track_mis: bool, group=None):
    """One epoch: ``step(state, t, train_data, val_buckets) → state``;
    nothing is read back. ``step.query_step`` is one query's step.
    ``group``: a ``-dp`` rank's process group; ``train_data.rows`` are then
    its lockstep slots (None where it has no query), and the pair count
    and the validation sum are summed across the ranks (``n_val_q``
    global)."""

    def one_query(params, row):
        if group is None:
            query_step(params, row, loss, scorer, lr)
        else:
            lockstep_step(params, row, loss, scorer, lr, group)

    def step(state: NNState, t: int, data: TrainData, vb) -> NNState:
        params = state.params
        with full_f32_products():
            for row in data.rows:
                one_query(params, row)
            if track_mis:
                tot = torch.zeros((), dtype=torch.int64,
                                  device=state.mis.device)
                for s, labels, mask in data.buckets.scores(params):
                    hi = torch.where(mask, labels, -torch.inf)
                    lo = torch.where(mask, labels, torch.inf)
                    bad = ((hi[:, :, None] > lo[:, None, :])
                           & (s[:, :, None] <= s[:, None, :]))
                    tot = tot + bad.sum()
                state.mis[t] = sum_across(tot, group)
            if vb is not None:           # on every rank alike
                tot = torch.zeros((), dtype=torch.float32,
                                  device=state.val_m.device)
                for s, labels, mask in vb.scores(params):
                    tot = tot + scorer.score_from_scores(labels, s,
                                                         mask).sum()
                val = sum_across(tot, group) / n_val_q
                state.val_m[t] = val
                better = val > state.best_val
                state.best_params = [[torch.where(better, a, b)
                                      for a, b in zip(p, bp)]
                                     for p, bp in zip(params,
                                                      state.best_params)]
                state.best_val = torch.where(better, val, state.best_val)
        return state

    step.query_step = one_query
    return step


@register_ranker
class RankNet(Ranker):
    NAME = "RankNet"
    LOSS = "ranknet"
    MODEL_FIELDS = ("params", "n_features")  # what a -dp fit takes from
                                             # rank 0

    def __init__(self, **hp):
        self.n_epoch = 100
        self.n_layers = 1               # hidden layers
        self.n_hidden_per_layer = 10
        self.learning_rate = 0.00005
        self.seed = 0                   # -randomSeed: the initial weights
        self.params = None              # [(W, b)] np.float32
        self.n_features = None
        self.rank_launches = None    # the last -dp fit's, a dict a rank
        super().__init__(**hp)

    def _layer_sizes(self, F):
        return [F] + [self.n_hidden_per_layer] * self.n_layers + [1]

    def initial_params(self, n_features: int) -> list:
        """[(W, b)] of the initial draws (the parent's under ``-dp``)."""
        return _init_params(torch.Generator().manual_seed(int(self.seed)),
                            self._layer_sizes(n_features))

    def prepare_fit(self, train: Dataset, scorer: MetricScorer,
                    validation, device, init=None, shard=None):
        """Upload and build the epoch: (step, state, train_data,
        val_buckets), at the initial weights (``init``, else
        :meth:`initial_params`). ``shard``: (rank, group) of a ``-dp``
        rank, which takes its lockstep slots of ``train`` and its shard of
        ``validation`` and sums across ``group``."""
        F = train.n_features
        if init is None:
            init = self.initial_params(F)
        params = [[torch.as_tensor(np.array(a, np.float32)).to(device)
                   for a in p] for p in init]
        vb = None
        group = None
        if shard is not None:
            from ranklib_tpu_torch.parallel.dp import shard_feat_buckets

            rank, group = shard
            n = torch.distributed.get_world_size(group)
            data = shard_train_rows(train, self.LOSS, device, rank, n)
            if validation is not None:
                vb = ScoredBuckets(shard_feat_buckets(validation, n, rank,
                                                      device)[0])
        elif wants_sparse_eval(train):
            data = sparse_train_rows(train, self.LOSS, device)
            if validation is not None:
                vb = ScoredBuckets(coo=build_sparse_data(validation, device))
        else:
            data = train_rows(train, self.LOSS, device)
            if validation is not None:
                vb = ScoredBuckets([t[:3] for t in device_class_buckets(
                    validation, device)])
        n_val_q = len(validation.queries) if validation is not None else 1
        step = make_epoch_step(self.LOSS, scorer, float(self.learning_rate),
                               n_val_q, track_mis=not is_silent(),
                               group=group)
        E = max(1, self.n_epoch)
        state = NNState(
            params=params,
            best_params=[[a.clone() for a in p] for p in params],
            best_val=torch.tensor(-np.inf, dtype=torch.float32,
                                  device=device),
            val_m=torch.full((E,), np.nan, dtype=torch.float32,
                             device=device),
            mis=torch.full((E,), np.nan, dtype=torch.float32, device=device))
        return step, state, data, vb

    def fit(self, train: Dataset, scorer: MetricScorer, validation=None,
            device: torch.device | None = None, mesh=None,
            profile_dir: str | None = None) -> None:
        """Train on ``device`` (default: :func:`choose_device`'s).
        ``mesh``: a ``parallel.dist.Mesh``; of more than one rank, the
        data-parallel fit, whose ranks write their profiler traces into
        ``profile_dir``. A sparse first layer ignores ``mesh`` (ref
        :331-333)."""
        device = choose_device(quiet=True) if device is None else device
        F = train.n_features
        sparse = wants_sparse_eval(train)
        if mesh is not None and mesh.size > 1 and not sparse:
            from ranklib_tpu_torch.parallel.dp import fit_many

            return fit_many(mesh, [(self, train, scorer, validation)],
                            profile_dir)
        self._epochs(*self.prepare_fit(train, scorer, validation, device),
                     F, validation is not None,
                     dp_ignored=mesh is not None and sparse)

    def dp_job(self, mesh, train: Dataset, scorer: MetricScorer,
               validation=None):
        """The ``parallel.dp.ShardJob`` of this fit on ``mesh``, with the
        initial draws made here (in every process of a joined mesh, from
        the same seed)."""
        from ranklib_tpu_torch.parallel.dp import make_job

        return make_job(self, mesh, train, scorer, validation, init=[
            (np.asarray(W, np.float32), np.asarray(b, np.float32))
            for W, b in self.initial_params(train.n_features)])

    def fit_shard(self, rank: int, device, group, train: Dataset,
                  scorer: MetricScorer, validation=None, init=None) -> None:
        """One rank's part of a data-parallel fit (``parallel.dp``) from
        the parent's initial draws ``init``."""
        self._epochs(*self.prepare_fit(train, scorer, validation, device,
                                       init, (rank, group)),
                     train.n_features, validation is not None)

    def _epochs(self, step, state, data, vb, F: int, has_val: bool,
                dp_ignored: bool = False) -> None:
        """The epoch loop (console table and ``"epoch"`` events) and the
        final or best-on-validation parameters."""
        self.n_features = F
        log(f"Training starts... [{self.NAME}] {self.n_epoch} epochs, "
            f"lr={float(self.learning_rate):g}, "
            f"layers={self._layer_sizes(F)}")
        log(f"{'#epoch':<8}| {'# mis-ordered pairs':<20}| {'validation':<10}")
        if dp_ignored:
            log("(sparse first layer is single-device; -dp ignored)")
        silent = is_silent()
        for epoch in range(1, self.n_epoch + 1):
            state = step(state, epoch - 1, data, vb)
            if not silent and (epoch % max(1, self.n_epoch // 10) == 0
                               or epoch == 1):
                mis = float(state.mis[epoch - 1])
                # the epoch's validation value, not the running best
                vm = (float(state.val_m[epoch - 1]) if has_val else None)
                vtxt = f"{vm:.4f}" if vm is not None else "-"
                log(f"{epoch:<8}| {mis:<20.0f}| {vtxt:<10}")
                event("epoch", ranker=self.NAME, epoch=epoch,
                      misordered_pairs=mis, best_val=vm)
        final = state.best_params if has_val else state.params
        self.params = [(W.cpu().numpy(), b.cpu().numpy()) for W, b in final]

    def eval_dataset(self, ds: Dataset, device: torch.device):
        """Per-query f64 scores; a data width other than the model's is
        zero-padded or clipped to it."""
        if self.params is None:
            raise RankLibError("Model not trained/loaded")
        F = self.params[0][0].shape[0]
        params = [(torch.from_numpy(np.asarray(W, np.float32)).to(device),
                   torch.from_numpy(np.asarray(b, np.float32)).to(device))
                  for W, b in self.params]
        out = [None] * len(ds.queries)
        w = min(F, ds.n_features)
        for b in iter_buckets(ds, with_feats=True):
            feats = b.feats
            if ds.n_features != F:
                feats = np.zeros((b.B, b.D, F), np.float32)
                feats[:, :, :w] = b.feats[:, :, :w]
            with full_f32_products():
                s = _forward(params, torch.from_numpy(feats).to(device))
            s = s.cpu().numpy()
            for row, qi in enumerate(b.qidx):
                out[qi] = s[row, : ds.queries[qi].n].astype(np.float64)
        return out

    def model_str(self) -> str:
        sizes = ([self.params[0][0].shape[0]]
                 + [W.shape[1] for W, _ in self.params])
        hdr = model_header(self.NAME, {
            "Epochs": self.n_epoch,
            "No. of features": sizes[0],
            "No. of hidden layers": len(sizes) - 2,
            "No. of hidden nodes per layer": self.n_hidden_per_layer,
            "Learning rate": self.learning_rate,
            "Layer sizes": " ".join(map(str, sizes)),
        })
        chunks = []
        for W, b in self.params:
            chunks.append(" ".join(repr(float(x)) for x in W.flatten()))
            chunks.append(" ".join(repr(float(x)) for x in b.flatten()))
        return hdr + "\n".join(chunks) + "\n"

    def load_str(self, text: str) -> None:
        params, body = parse_model_params(text)
        try:
            sizes = [int(s) for s in params["Layer sizes"].split()]
        except KeyError:
            raise RankLibError(
                f"{self.NAME} model missing 'Layer sizes'") from None
        if "Epochs" in params:
            self.n_epoch = int(params["Epochs"])
        if "Learning rate" in params:
            self.learning_rate = float(params["Learning rate"])
        self.n_layers = len(sizes) - 2
        if self.n_layers > 0:
            self.n_hidden_per_layer = sizes[1]
        vals = iter(body)
        out = []
        for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
            W = np.array(next(vals).split(), np.float64).reshape(fan_in,
                                                                 fan_out)
            b = np.array(next(vals).split(), np.float64)
            out.append((W.astype(np.float32), b.astype(np.float32)))
        self.params = out
        self.n_features = sizes[0]


@register_ranker
class LambdaRank(RankNet):
    NAME = "LambdaRank"
    LOSS = "lambdarank"


@register_ranker
class ListNet(RankNet):
    NAME = "ListNet"
    LOSS = "listnet"

    def __init__(self, **hp):
        # a linear scorer (ref: ListNet)
        super().__init__(**{"n_epoch": 1500, "learning_rate": 0.00001,
                            "n_layers": 0, **hp})
