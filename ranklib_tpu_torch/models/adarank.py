"""AdaRank (`-ranker 3`; ranklib_tpu.models.adarank; ref:
learning/boosting/AdaRank.java).

Listwise boosting whose weak rankers are single features (a query's
documents ranked by one feature, descending). With query weights P
(uniform at first), a round:

* picks the feature maximizing Σ_q P(q)·metric(q ranked by the feature);
* weighs it α = ½ln(Σ P(1 + s) / Σ P(1 − s)), s the feature's per-query
  metric; the strong ranker H = Σ α_t·feature_{f_t} is linear;
* reweighs P ∝ exp(−metric(q, H));
* ``-noeq`` forbids picking the last feature again, ``-max`` (5) caps
  consecutive picks of one feature, ``-tolerance`` (0.002) stops when the
  train metric stalls, and a round that lowers the train metric is rolled
  back.

A query's ranking by a feature never changes, so the weak-metric matrix
S[q, f] is computed once (``LinearMetricEvaluator.per_query_matrix`` of
the identity). A round — the pick, α, the strong model's per-query
metric, P, the guards and the stop rules as flags — runs on the device
and reads nothing back; the console table reads a round's values when it
prints them. Flags: ``-round`` 500, ``-tolerance``, ``-noeq``, ``-max``.

A ``-sparse`` CSR file above the device budget takes the COO route
(``ops.sparse_eval``): S is built from the present (query, feature)
pairs only, and the strong model scores through the COO layer. Below
the budget its dense buckets come in bounded chunks.

Under ``-dp`` (``mesh``, ``parallel.dp``) each rank holds its shard of
the queries: its rows of S and its slots of P, in its own query order
(``per_dev``), its dense buckets or its COO layer, and its validation
shard. P·S, α's numerator and denominator, the reweighting normalizer
Σe^{−metric} and the metric sums are summed across the ranks, every mean
divides by the global query count, and so the pick, α, the guards and
the stop rules are the same on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ranklib_tpu_torch.data.dataset import Dataset
from ranklib_tpu_torch.device import choose_device
from ranklib_tpu_torch.gbdt.boost import round_capacity, run_silent_rounds
from ranklib_tpu_torch.gbdt.grow import sum_across
from ranklib_tpu_torch.metrics.base import MetricScorer
from ranklib_tpu_torch.models.base import (
    Ranker, model_header, parse_model_params, register_ranker,
)
from ranklib_tpu_torch.ops.batched_eval import (
    LinearMetricEvaluator, full_f32_products, linear_scores,
)
from ranklib_tpu_torch.ops.sparse_eval import (
    adarank_weak_matrix, build_sparse_data, sparse_scores_flat,
    wants_sparse_eval,
)
from ranklib_tpu_torch.utils.errors import RankLibError
from ranklib_tpu_torch.utils.logging import event, is_silent, log


@dataclass
class AdaState:
    """The round's carry, updated in place."""

    P: torch.Tensor              # [Q] query weights
    w: torch.Tensor              # [F] accumulated α per feature
    last_fid: torch.Tensor       # [] int64 (-1 at first)
    consec: torch.Tensor         # [] int64 consecutive picks of last_fid
    prev_train: torch.Tensor     # [] f32
    active: torch.Tensor         # [] bool
    hfid: torch.Tensor           # [CAP] int64 picked feature per round
    halpha: torch.Tensor         # [CAP] f32
    hact: torch.Tensor           # [CAP] bool, round kept
    train_m: torch.Tensor        # [CAP] f32
    val_m: torch.Tensor          # [CAP] f32


def init_state(Q: int, F: int, CAP: int, device,
               qmask: torch.Tensor | None = None) -> AdaState:
    """The uniform start over ``Q`` queries; ``qmask``: a ``-dp`` rank's
    real slots (P is 1/Q there, 0 on padded slots)."""
    f32 = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    P = torch.full((Q,) if qmask is None else qmask.shape, 1.0 / Q, **f32)
    return AdaState(
        P=P if qmask is None else torch.where(qmask, P, 0.0),
        w=torch.zeros(F, **f32),
        last_fid=torch.full((), -1, **i64),
        consec=torch.zeros((), **i64),
        prev_train=torch.full((), -torch.inf, **f32),
        active=torch.ones((), dtype=torch.bool, device=device),
        hfid=torch.zeros(CAP, **i64),
        halpha=torch.zeros(CAP, **f32),
        hact=torch.zeros(CAP, dtype=torch.bool, device=device),
        train_m=torch.full((CAP,), torch.nan, **f32),
        val_m=torch.full((CAP,), torch.nan, **f32))


def device_buckets(ev: LinearMetricEvaluator, n_queries: int) -> list:
    """The evaluator's chunks with each row's query index on the device,
    pad rows → the sentinel ``n_queries``."""
    out = []
    for feats, labels, mask, qidx in ev.buckets:
        q = np.full(feats.shape[0], n_queries, np.int64)
        q[: len(qidx)] = qidx
        out.append((feats, labels, mask,
                    torch.from_numpy(q).to(feats.device)))
    return out


def make_ada_step(scorer, *, no_eq: bool, max_sel: int, tolerance: float,
                  n_queries: int, n_vqueries: int, has_val: bool,
                  sparse_docs: tuple | None = None, group=None,
                  slots: tuple | None = None):
    """The round: ``step(state, t, S, tb, vb[, qmask]) → state`` with
    ``S [Q, F]`` and ``tb``/``vb`` :func:`device_buckets`, on one device,
    with no host sync. ``has_val``: a validation set exists (on every
    rank alike, whatever this rank's shard of it holds). ``sparse_docs``:
    (train docs, validation docs) when
    ``tb``/``vb`` are ``(coo_chunks, (labels, mask, didx, qidx) buckets)``
    of the COO route. Under ``-dp``: ``group``, the rank's process group
    (``n_queries``/``n_vqueries`` are the global counts); ``slots``, its
    (training, validation) query slot counts, the rows of ``S`` and of
    ``qmask`` (True on its real slots)."""
    n_slots, n_vslots = slots or (n_queries, n_vqueries)

    def perq_and_mean(wvec, buckets, n_slots, nq, n_docs):
        """Per-query metric [n_slots] of the linear model ``wvec`` and the
        mean over ``nq`` queries."""
        perq = torch.zeros(n_slots + 1, dtype=torch.float32,
                           device=wvec.device)
        if sparse_docs is not None:
            chunks, bks = buckets
            flat = sparse_scores_flat(wvec[:, None], chunks, n_docs)[:, 0]
            for labels, mask, didx, qidx in bks:
                perq[qidx] = scorer.score_from_scores(labels, flat[didx],
                                                      mask)
        else:
            for feats, labels, mask, qidx in buckets:
                sc = torch.matmul(feats, wvec)
                perq[qidx] = scorer.score_from_scores(labels, sc, mask)
        perq = perq[:-1]
        return perq, sum_across(perq.sum(), group) / nq

    n_docs, n_vdocs = sparse_docs or (None, None)

    def step(state: AdaState, t: int, S, tb, vb, qmask=None) -> AdaState:
        F = state.w.shape[0]
        weighted = sum_across(state.P @ S, group)              # [F]
        blocked = (torch.arange(F, device=S.device) == state.last_fid) & (
            (state.consec >= max_sel) | no_eq)
        fid = torch.argmax(torch.where(blocked, -torch.inf, weighted))
        s = S.index_select(1, fid.view(1))[:, 0]
        num = sum_across(state.P @ (1.0 + s), group)
        den = sum_across(state.P @ (1.0 - s), group)
        degenerate = (num <= 0) | (den <= 0)
        alpha = 0.5 * torch.log(torch.where(degenerate, 1.0, num / den))
        w_new = state.w.index_add(0, fid.view(1), alpha.view(1))
        perq, m_train = perq_and_mean(w_new, tb, n_slots, n_queries,
                                      n_docs)
        backtrack = m_train < state.prev_train
        keep = state.active & ~degenerate & ~backtrack
        e = torch.exp(-perq)
        if qmask is not None:
            e = torch.where(qmask, e, 0.0)
        state.w = torch.where(keep, w_new, state.w)
        state.P = torch.where(keep, e / sum_across(e.sum(), group), state.P)
        state.consec = torch.where(
            keep, torch.where(fid == state.last_fid, state.consec + 1, 1),
            state.consec)
        state.last_fid = torch.where(keep, fid, state.last_fid)
        # the tolerance stop keeps its round; later rounds are no-ops
        tol_stop = keep & (m_train - state.prev_train < tolerance) & (t > 0)
        state.active = keep & ~tol_stop
        state.prev_train = torch.where(keep, m_train, state.prev_train)
        if has_val:
            state.val_m[t] = perq_and_mean(state.w, vb, n_vslots,
                                           n_vqueries, n_vdocs)[1]
        state.hfid[t] = fid
        state.halpha[t] = alpha
        state.hact[t] = keep
        state.train_m[t] = m_train
        return state

    return step


@register_ranker
class AdaRank(Ranker):
    NAME = "AdaRank"
    MODEL_FIELDS = ("history", "weights")  # what a -dp fit takes from rank 0

    def __init__(self, **hp):
        self.n_rounds = 500
        self.tolerance = 0.002
        self.no_eq = False           # -noeq: never reselect the last feature
        self.max_sel_count = 5       # consecutive-pick cap otherwise
        self.weights = None          # np.float64 [F] accumulated α per fid
        self.history: list[tuple[int, float]] = []   # (fid, α) per round
        self.fit_state = None        # the last fit's AdaState
        self.rank_launches = None    # the last -dp fit's, a dict a rank
        super().__init__(**hp)

    def prepare_fit(self, train: Dataset, scorer: MetricScorer, validation,
                    device):
        """Upload, compute S and build the round: (step, state, S, tb,
        vb)."""
        F = train.n_features
        Q = len(train.queries)
        n_vq = len(validation.queries) if validation is not None else 1
        sparse_docs = None
        if wants_sparse_eval(train):
            # S from the present (query, feature) pairs; the strong model
            # scores through the COO layer
            S = torch.from_numpy(adarank_weak_matrix(train, scorer,
                                                     device)).to(device)
            chunks, bks, n_docs = build_sparse_data(train, device,
                                                    with_qidx=True)
            tb, vb, n_vdocs = (chunks, bks), (), 1
            if validation is not None:
                vchunks, vbks, n_vdocs = build_sparse_data(
                    validation, device, with_qidx=True)
                vb = (vchunks, vbks)
            sparse_docs = (n_docs, n_vdocs)
        else:
            ev = LinearMetricEvaluator(train, scorer, device)
            # S[q, f]: the metric of query q ranked by feature f alone
            S = torch.from_numpy(ev.per_query_matrix(
                np.eye(F, dtype=np.float32)).astype(np.float32)).to(device)
            tb = device_buckets(ev, Q)
            vb = []
            if validation is not None:
                vb = device_buckets(
                    LinearMetricEvaluator(validation, scorer, device), n_vq)
        step = make_ada_step(
            scorer, no_eq=bool(self.no_eq), max_sel=self.max_sel_count,
            tolerance=self.tolerance, n_queries=Q, n_vqueries=n_vq,
            has_val=validation is not None, sparse_docs=sparse_docs)
        state = init_state(Q, F, round_capacity(self.n_rounds), device)
        return step, state, S, tb, vb

    def prepare_shard(self, rank: int, device, group, train: Dataset,
                      scorer: MetricScorer, validation):
        """A ``-dp`` rank's :meth:`prepare_fit`: (step, state, S, tb, vb,
        qmask) of its shard (``parallel.dp``), S's rows and P's slots in
        its query order, sums across ``group``."""
        from ranklib_tpu_torch.ops.batched_eval import (
            _DOC_BUDGET, candidate_metrics,
        )
        from ranklib_tpu_torch.parallel.dp import (
            shard_feat_buckets, shard_sparse_data,
        )

        n = torch.distributed.get_world_size(group)
        F = train.n_features
        Q = len(train.queries)
        n_vq = len(validation.queries) if validation is not None else 1
        sparse_docs = None
        n_vslots = n_vq
        if wants_sparse_eval(train):
            chunks, bks, Qpad, Npad, per_dev = shard_sparse_data(
                train, n, rank, device)
            mine = [qi for _, qi in per_dev[rank]]
            S = np.zeros((Qpad, F), np.float32)
            S[: len(mine)] = adarank_weak_matrix(train, scorer, device, mine)
            S = torch.from_numpy(S).to(device)
            tb, vb, Nvpad = (chunks, bks), (), 1
            if validation is not None:
                vchunks, vbks, n_vslots, Nvpad, _ = shard_sparse_data(
                    validation, n, rank, device)
                vb = (vchunks, vbks)
            sparse_docs = (Npad, Nvpad)
        else:
            tb, Qpad, per_dev = shard_feat_buckets(
                train, n, rank, device, want_qidx=True,
                doc_budget=_DOC_BUDGET)
            # S[slot, f]: each of the rank's queries ranked by feature f
            eye = torch.eye(F, dtype=torch.float32, device=device)
            S = torch.zeros((Qpad + 1, F), dtype=torch.float32,
                            device=device)
            with full_f32_products():
                for feats, labels, mask, qidx in tb:
                    S[qidx] = candidate_metrics(scorer, feats, labels, mask,
                                                eye)
            S = S[:-1].contiguous()
            vb = []
            if validation is not None:
                vb, n_vslots, _ = shard_feat_buckets(
                    validation, n, rank, device, want_qidx=True,
                    doc_budget=_DOC_BUDGET)
        qmask = torch.arange(Qpad, device=device) < len(per_dev[rank])
        step = make_ada_step(
            scorer, no_eq=bool(self.no_eq), max_sel=self.max_sel_count,
            tolerance=self.tolerance, n_queries=Q, n_vqueries=n_vq,
            has_val=validation is not None, sparse_docs=sparse_docs,
            group=group, slots=(Qpad, n_vslots))
        state = init_state(Q, F, round_capacity(self.n_rounds), device,
                           qmask)
        return step, state, S, tb, vb, qmask

    def fit(self, train: Dataset, scorer: MetricScorer,
            validation: Dataset | None = None,
            device: torch.device | None = None, mesh=None,
            profile_dir: str | None = None) -> None:
        """Train on ``device`` (default: :func:`choose_device`'s).
        ``mesh``: a ``parallel.dist.Mesh``; of more than one rank, the
        data-parallel fit, whose ranks write their profiler traces into
        ``profile_dir``."""
        device = choose_device(quiet=True) if device is None else device
        if mesh is not None and mesh.size > 1:
            from ranklib_tpu_torch.parallel.dp import fit_many

            return fit_many(mesh, [(self, train, scorer, validation)],
                            profile_dir)
        self._rounds(*self.prepare_fit(train, scorer, validation, device),
                     scorer=scorer, n_features=train.n_features,
                     has_val=validation is not None)

    def dp_job(self, mesh, train: Dataset, scorer: MetricScorer,
               validation=None):
        """The ``parallel.dp.ShardJob`` of this fit on ``mesh``."""
        from ranklib_tpu_torch.parallel.dp import make_job

        return make_job(self, mesh, train, scorer, validation)

    def fit_shard(self, rank: int, device, group, train: Dataset,
                  scorer: MetricScorer, validation=None) -> None:
        """One rank's part of a data-parallel fit (``parallel.dp``)."""
        self._rounds(*self.prepare_shard(rank, device, group, train, scorer,
                                         validation),
                     scorer=scorer, n_features=train.n_features,
                     has_val=validation is not None)

    def _rounds(self, step, state, *data, scorer, n_features: int,
                has_val: bool) -> None:
        """The round loop (console table and ``"round"`` events) and the
        history, cut back to the best validation round."""
        log("Training starts...")
        head = f"{'#iter':<8}| {'Feature':<8}| {scorer.name + '-T':<11}"
        if has_val:
            head += f"| {scorer.name + '-V':<11}"
        log(head)
        silent = is_silent()
        with full_f32_products():
            if silent:
                state = run_silent_rounds(step, state, self.n_rounds, *data)
            for t in ([] if silent else range(self.n_rounds)):
                state = step(state, t, *data)
                if not bool(state.hact[t]):
                    log(f"Stop at round {t + 1} (degenerate or rolled back)")
                    break
                tm = float(state.train_m[t])
                line = (f"{t + 1:<8}| {int(state.hfid[t]) + 1:<8}| "
                        f"{tm:<11.4f}")
                vm = None
                if has_val:
                    vm = float(state.val_m[t])
                    line += f"| {vm:<11.4f}"
                log(line)
                event("round", ranker=self.NAME, round=t + 1,
                      train_metric=tm, val_metric=vm)
                if not bool(state.active):
                    break
        self.fit_state = state
        hfid, halpha, hact, val_m = (a.cpu().numpy() for a in (
            state.hfid, state.halpha, state.hact, state.val_m))
        kept = [t for t in range(self.n_rounds) if hact[t]]
        self.history = [(int(hfid[t]) + 1, float(halpha[t])) for t in kept]
        if has_val and kept:
            best = int(np.nanargmax(val_m[kept]))
            self.history = self.history[: best + 1]
        w = np.zeros(n_features, np.float64)
        for fid, alpha in self.history:
            w[fid - 1] += alpha
        self.weights = w

    def eval_dataset(self, ds: Dataset, device: torch.device):
        if self.weights is None:
            raise RankLibError("Model not trained/loaded")
        return linear_scores(ds, self.weights, device)

    def model_str(self) -> str:
        head = model_header(self.NAME, {
            "Iteration": self.n_rounds,
            # -noeq turns enqueue-style retraining OFF (ref AdaRank
            # trainWithEnqueue = true by default)
            "Train with 'enqueue'": "No" if self.no_eq else "Yes",
        })
        body = " ".join(f"{fid}:{alpha}" for fid, alpha in self.history)
        return head + body + "\n"

    def load_str(self, text: str) -> None:
        _, body = parse_model_params(text)
        self.history = []
        for line in body:
            for tok in line.split():
                fid, _, a = tok.partition(":")
                self.history.append((int(fid), float(a)))
        if not self.history:
            raise RankLibError("Empty AdaRank model body")
        w = np.zeros(max(fid for fid, _ in self.history), np.float64)
        for fid, alpha in self.history:
            w[fid - 1] += alpha
        self.weights = w
