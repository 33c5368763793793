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

Initial weights are U(−0.05, 0.05) from a ``torch.Generator`` seeded with
``-randomSeed`` on the CPU, so the card and the CPU start alike; the
reference draws from ``jax.random``, so the same seed gives other initial
weights in the two packages (tests inject the reference's draws). Dense
input on one device; ``-sparse`` and ``-dp`` are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ranklib_tpu_torch.data.dataset import Dataset, iter_buckets
from ranklib_tpu_torch.device import choose_device
from ranklib_tpu_torch.metrics.base import MetricScorer
from ranklib_tpu_torch.models.base import (
    Ranker, model_header, parse_model_params, register_ranker,
)
from ranklib_tpu_torch.ops.batched_eval import full_f32_products
from ranklib_tpu_torch.ops.sorting import rank_perm
from ranklib_tpu_torch.utils.errors import RankLibError
from ranklib_tpu_torch.utils.logging import is_silent, log


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


def query_step(params, row, loss: str, scorer: MetricScorer,
               lr: float) -> None:
    """One SGD step on one query, in place on ``params`` ([W, b] lists):
    ``row`` = (x [n, F], labels [n], aux) of its real documents."""
    x, labels, aux = row
    hs = [x]
    for W, b in params:
        hs.append(torch.sigmoid(torch.addmm(b, hs[-1], W)))
    g = _dloss_ds(loss, hs[-1][:, 0], labels, aux, scorer)
    delta = g[:, None] * hs[-1] * (1.0 - hs[-1])
    grads = [None] * (2 * len(params))
    for li in range(len(params) - 1, -1, -1):
        grads[2 * li] = hs[li].T @ delta
        grads[2 * li + 1] = delta.sum(0)
        if li:
            delta = (delta @ params[li][0].T) * hs[li] * (1.0 - hs[li])
    torch._foreach_add_([t for p in params for t in p], grads, alpha=-lr)


@dataclass
class NNState:
    """The fit's carry, all on the device."""

    params: list                 # [[W, b], ...], updated in place
    best_params: list            # snapshot of the best-on-validation epoch
    best_val: torch.Tensor       # []
    val_m: torch.Tensor          # [n_epoch] validation metric per epoch
    mis: torch.Tensor            # [n_epoch] mis-ordered pairs (console)


@dataclass
class TrainData:
    """``rows``: one (x, labels, aux) per query with documents, in visit
    order; ``buckets``: the padded (feats, labels, mask) blocks."""

    rows: list
    buckets: list


def _upload(ds: Dataset, device) -> list:
    """(feats [B, D, F], labels [B, D], mask [B, D], bucket) per bucket."""
    out = []
    for b in iter_buckets(ds, with_feats=True):
        out.append((torch.from_numpy(b.feats).to(device),
                    torch.from_numpy(b.labels).to(device),
                    torch.from_numpy(b.mask).to(device), b))
    return out


def train_rows(ds: Dataset, loss: str, device) -> TrainData:
    """Upload the training buckets and cut one row a query: views of its
    real documents, plus what its loss needs besides (ListNet's target
    distribution; LambdaRank's all-real mask row and doc count)."""
    rows, buckets = [], []
    for feats, labels, mask, b in _upload(ds, device):
        buckets.append((feats, labels, mask))
        n_docs = mask.sum(dim=1, dtype=torch.int32)
        if loss == "listnet":
            target = torch.softmax(torch.where(mask, labels, -1e30), dim=1)
        for r, qi in enumerate(b.qidx):
            n = ds.queries[qi].n
            if n == 0:                   # no real document: no step
                continue
            aux = (target[r, :n] if loss == "listnet" else
                   (mask[r:r + 1, :n], n_docs[r:r + 1])
                   if loss == "lambdarank" else None)
            rows.append((feats[r, :n], labels[r, :n], aux))
    return TrainData(rows, buckets)


def make_epoch_step(loss: str, scorer: MetricScorer, lr: float,
                    n_val_q: int, track_mis: bool):
    """One epoch: ``step(state, t, train_data, val_buckets) → state``;
    nothing is read back. ``step.query_step`` is one query's step."""

    def step(state: NNState, t: int, data: TrainData, vb) -> NNState:
        params = state.params
        with full_f32_products():
            for row in data.rows:
                query_step(params, row, loss, scorer, lr)
            if track_mis:
                tot = torch.zeros((), dtype=torch.int64,
                                  device=state.mis.device)
                for feats, labels, mask in data.buckets:
                    s = _forward(params, feats)
                    hi = torch.where(mask, labels, -torch.inf)
                    lo = torch.where(mask, labels, torch.inf)
                    bad = ((hi[:, :, None] > lo[:, None, :])
                           & (s[:, :, None] <= s[:, None, :]))
                    tot = tot + bad.sum()
                state.mis[t] = tot
            if vb:
                tot = torch.zeros((), dtype=torch.float32,
                                  device=state.val_m.device)
                for feats, labels, mask in vb:
                    tot = tot + scorer.score_from_scores(
                        labels, _forward(params, feats), mask).sum()
                val = tot / n_val_q
                state.val_m[t] = val
                better = val > state.best_val
                state.best_params = [[torch.where(better, a, b)
                                      for a, b in zip(p, bp)]
                                     for p, bp in zip(params,
                                                      state.best_params)]
                state.best_val = torch.where(better, val, state.best_val)
        return state

    def one_query(params, row):
        query_step(params, row, loss, scorer, lr)

    step.query_step = one_query
    return step


@register_ranker
class RankNet(Ranker):
    NAME = "RankNet"
    LOSS = "ranknet"

    def __init__(self, **hp):
        self.n_epoch = 100
        self.n_layers = 1               # hidden layers
        self.n_hidden_per_layer = 10
        self.learning_rate = 0.00005
        self.seed = 0                   # -randomSeed: the initial weights
        self.params = None              # [(W, b)] np.float32
        self.n_features = None
        super().__init__(**hp)

    def _layer_sizes(self, F):
        return [F] + [self.n_hidden_per_layer] * self.n_layers + [1]

    def prepare_fit(self, train: Dataset, scorer: MetricScorer,
                    validation, device):
        """Upload and build the epoch: (step, state, train_data,
        val_buckets), at the initial weights."""
        F = train.n_features
        init = _init_params(torch.Generator().manual_seed(int(self.seed)),
                            self._layer_sizes(F))
        params = [[torch.as_tensor(np.array(a, np.float32)).to(device)
                   for a in p] for p in init]
        data = train_rows(train, self.LOSS, device)
        vb = ([t[:3] for t in _upload(validation, device)]
              if validation is not None else [])
        n_val_q = len(validation.queries) if validation is not None else 1
        step = make_epoch_step(self.LOSS, scorer, float(self.learning_rate),
                               n_val_q, track_mis=not is_silent())
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
            device: torch.device | None = None) -> None:
        """Train on ``device`` (default: :func:`choose_device`'s)."""
        device = choose_device(quiet=True) if device is None else device
        F = train.n_features
        self.n_features = F
        step, state, data, vb = self.prepare_fit(train, scorer, validation,
                                                 device)
        log(f"Training starts... [{self.NAME}] {self.n_epoch} epochs, "
            f"lr={float(self.learning_rate):g}, "
            f"layers={self._layer_sizes(F)}")
        log(f"{'#epoch':<8}| {'# mis-ordered pairs':<20}| {'validation':<10}")
        silent = is_silent()
        for epoch in range(1, self.n_epoch + 1):
            state = step(state, epoch - 1, data, vb)
            if not silent and (epoch % max(1, self.n_epoch // 10) == 0
                               or epoch == 1):
                mis = float(state.mis[epoch - 1])
                # the epoch's validation value, not the running best
                vtxt = (f"{float(state.val_m[epoch - 1]):.4f}"
                        if validation is not None else "-")
                log(f"{epoch:<8}| {mis:<20.0f}| {vtxt:<10}")
        final = state.best_params if validation is not None else state.params
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
