"""Coordinate Ascent (`-ranker 4`, the CLI's default;
ranklib_tpu.models.coorascent; ref: learning/CoorAscent.java).

A linear model wᵀx that maximizes the metric directly by cyclic
coordinate line search: weights start uniform 1/F; each restart visits
the features in its own shuffled order; a coordinate's candidates are a
geometric ladder of deltas in both signs, its sign flip and its zeroing;
weights renormalize to Σ|w| = 1; a change is kept only when the metric
gains more than ``-tolerance``; the best restart wins. ``-reg`` subtracts
λΣw² from the objective.

The R restarts advance in lockstep, and every candidate of a coordinate
(R x (2·depth + 2)) is scored by one batched product and metric call a
bucket chunk (``ops.batched_eval``). A sweep over all coordinates runs on
the device with no host sync; the host reads once a sweep, the restarts'
improved flags.

A ``-sparse`` CSR file under the device budget is scored from its
dense buckets, materialized in bounded chunks; above it
(``ops.sparse_eval.wants_sparse_eval``) the candidates are scored by the
COO layer (a gather of candidate rows by fid and a sum over each
document's entries), with the same sweep around it.

Under ``-dp`` (``mesh``, ``parallel.dp``) each rank scores the candidates
on its shard of the queries (dense buckets or its COO layer) and the
candidates' metric totals ``[R·C]`` are summed across the ranks once a
coordinate, so every rank takes the same decisions. The starting metric
comes from the same summed instrument: a baseline computed otherwise
could differ from it by more than ``-tolerance`` and flip a first-sweep
decision (ref :121-125, :245-250).

Flags and defaults: ``-r`` 5, ``-i`` 25 (ladder depth), ``-tolerance``
0.001, ``-reg`` off, ``-randomSeed`` → ``seed`` (offsets the restarts'
shuffles).
"""

from __future__ import annotations

import numpy as np
import torch

from ranklib_tpu_torch.data.dataset import Dataset
from ranklib_tpu_torch.device import choose_device
from ranklib_tpu_torch.gbdt.grow import sum_across
from ranklib_tpu_torch.metrics.base import MetricScorer
from ranklib_tpu_torch.models.base import (
    Ranker, model_header, parse_model_params, register_ranker,
)
from ranklib_tpu_torch.ops.batched_eval import (
    LinearMetricEvaluator, candidate_metrics, full_f32_products,
    linear_scores,
)
from ranklib_tpu_torch.ops.sparse_eval import (
    build_sparse_data, sparse_mean_metric, wants_sparse_eval,
)
from ranklib_tpu_torch.utils.errors import RankLibError
from ranklib_tpu_torch.utils.logging import event, log


def restart_orders(n_features: int, n_restart: int, seed: int) -> np.ndarray:
    """``[F, R]`` coordinate order of each restart: restart r visits
    ``np.random.default_rng(seed + r).permutation(F)``, the reference's
    draws exactly."""
    return np.stack([np.random.default_rng(seed + r).permutation(n_features)
                     for r in range(n_restart)], axis=1)


def make_sweep(scorer, *, n_features: int, depth: int, reg: float | None,
               tolerance: float, n_queries: int, step_base: float,
               step_scale: float, sparse_n: int | None = None,
               group=None):
    """One sweep over every coordinate: ``sweep(w, cur, order_T, buckets)
    → (w, cur, improved)`` with ``w [R, F]``, ``cur [R]``, ``order_T
    [F, R]`` int64 and ``buckets`` (feats, labels, mask) chunks, all on
    one device; nothing is read back. ``sweep.coordinate_step`` is one
    coordinate's step, ``sweep.mean_metric`` its candidates' instrument.
    ``sparse_n``: the document count when ``buckets`` is ``(coo_chunks,
    metric_buckets)`` of ``ops.sparse_eval``. ``group``: a ``-dp`` rank's
    process group; the candidates' metric totals are summed over it and
    ``n_queries`` is the global count."""
    F = n_features

    def mean_metric(Wc, buckets):
        """Wc [R, C, F] → mean metric [R, C] over all queries (f32)."""
        R, C = Wc.shape[0], Wc.shape[1]
        Wf = Wc.reshape(R * C, F).T
        if sparse_n is not None:
            chunks, sbuckets = buckets
            return sparse_mean_metric(scorer, Wf.contiguous(), chunks,
                                      sbuckets, sparse_n, n_queries,
                                      group).view(R, C)
        total = torch.zeros(R * C, dtype=torch.float32, device=Wc.device)
        for feats, labels, mask in buckets:
            total += candidate_metrics(scorer, feats, labels, mask,
                                       Wf).sum(dim=0)
        return sum_across(total, group).view(R, C) / n_queries

    def coordinate_step(w, cur, improved, f, buckets):
        R = w.shape[0]
        dev = w.device
        rr = torch.arange(R, device=dev)
        w_f = w[rr, f]
        base = step_base * torch.clamp(w_f.abs(), min=0.05)
        mags = base[:, None] * (step_scale ** torch.arange(
            depth, dtype=torch.float32, device=dev))
        deltas = torch.cat([mags, -mags, -w_f[:, None], -2.0 * w_f[:, None]],
                           dim=1)                              # [R, C]
        onehot = (torch.arange(F, device=dev)[None, :]
                  == f[:, None]).to(torch.float32)
        Wc = w[:, None, :] + deltas[:, :, None] * onehot[:, None, :]
        norms = Wc.abs().sum(dim=2)                            # [R, C]
        ok = norms > 1e-12
        Wc = Wc / torch.where(ok, norms, 1.0)[:, :, None]
        vals = mean_metric(Wc, buckets)
        if reg is not None:
            vals = vals - reg * (Wc * Wc).sum(dim=2)
        vals = torch.where(ok, vals, -torch.inf)
        cbest = vals.argmax(dim=1)                            # first max
        vbest = vals[rr, cbest]
        gain = vbest > cur + tolerance
        w = torch.where(gain[:, None], Wc[rr, cbest], w)
        cur = torch.where(gain, vbest, cur)
        return w, cur, improved | gain

    def sweep(w, cur, order_T, buckets):
        improved = torch.zeros(w.shape[0], dtype=torch.bool, device=w.device)
        with full_f32_products():
            for f in order_T:
                w, cur, improved = coordinate_step(w, cur, improved, f,
                                                   buckets)
        return w, cur, improved

    sweep.coordinate_step = coordinate_step
    sweep.mean_metric = mean_metric
    return sweep


@register_ranker
class CoorAscent(Ranker):
    NAME = "Coordinate Ascent"
    MODEL_FIELDS = ("weights",)        # what a -dp fit takes from rank 0

    STEP_BASE = 0.05
    STEP_SCALE = 2.0

    def __init__(self, **hp):
        self.n_restart = 5
        self.n_max_iteration = 25     # geometric-ladder depth per coordinate
        self.tolerance = 0.001
        self.reg = None               # L2 penalty weight (None = off)
        self.max_passes = 25          # full feature sweeps per restart
        self.seed = 0                 # -randomSeed: offsets restart shuffles
        self.weights = None           # np.float64 [F], Σ|w| = 1
        self.rank_launches = None    # the last -dp fit's, a dict a rank
        super().__init__(**hp)

    def prepare_fit(self, train: Dataset, scorer: MetricScorer, device,
                    shard: tuple | None = None):
        """Upload and build the sweep: (sweep, w, cur, order_T, buckets),
        the restarts' state at the uniform start. ``shard``: (rank,
        group) of a ``-dp`` rank, which takes its shard of ``train``
        (``parallel.dp``) and sums across ``group``."""
        F = train.n_features
        R = self.n_restart
        w0 = np.full((F, 1), 1.0 / F, np.float32)
        sparse_n = None
        group = None
        if shard is not None:
            from ranklib_tpu_torch.ops.batched_eval import _DOC_BUDGET
            from ranklib_tpu_torch.parallel.dp import (
                shard_feat_buckets, shard_sparse_data,
            )

            rank, group = shard
            n = torch.distributed.get_world_size(group)
            if wants_sparse_eval(train):
                chunks, sbuckets, _, sparse_n, _ = shard_sparse_data(
                    train, n, rank, device, want_qidx=False)
                buckets = (chunks, sbuckets)
            else:
                # the single-device evaluator's [rows·D] cap
                buckets = [c[:3] for c in shard_feat_buckets(
                    train, n, rank, device, doc_budget=_DOC_BUDGET)[0]]
        elif wants_sparse_eval(train):
            chunks, sbuckets, sparse_n = build_sparse_data(train, device)
            buckets = (chunks, sbuckets)
            with full_f32_products():
                cur0 = float(sparse_mean_metric(
                    scorer, torch.from_numpy(w0).to(device), chunks,
                    sbuckets, sparse_n, len(train.queries))[0])
        else:
            ev = LinearMetricEvaluator(train, scorer, device)
            buckets = [(f, lab, m) for f, lab, m, _ in ev.buckets]
            cur0 = float(ev.mean_metric(w0)[0])
        order_T = torch.from_numpy(restart_orders(F, R, self.seed)).to(device)
        sweep = make_sweep(
            scorer, n_features=F, depth=max(1, self.n_max_iteration),
            reg=self.reg, tolerance=self.tolerance,
            n_queries=len(train.queries), step_base=self.STEP_BASE,
            step_scale=self.STEP_SCALE, sparse_n=sparse_n, group=group)
        if shard is not None:
            # the baseline from the candidates' own summed instrument
            with full_f32_products():
                cur0 = float(sweep.mean_metric(
                    torch.from_numpy(w0.T[None]).to(device), buckets)[0, 0])
        w = torch.full((R, F), 1.0 / F, dtype=torch.float32, device=device)
        if self.reg is not None:
            cur0 -= self.reg * (1.0 / F)     # Σ(1/F)² over F coordinates
        cur = torch.full((R,), cur0, dtype=torch.float32, device=device)
        return sweep, w, cur, order_T, buckets

    def fit(self, train: Dataset, scorer: MetricScorer, validation=None,
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
        self._sweeps(*self.prepare_fit(train, scorer, device), scorer,
                     validation, device)

    def dp_job(self, mesh, train: Dataset, scorer: MetricScorer,
               validation=None):
        """The ``parallel.dp.ShardJob`` of this fit on ``mesh``."""
        from ranklib_tpu_torch.parallel.dp import make_job

        return make_job(self, mesh, train, scorer, validation)

    def fit_shard(self, rank: int, device, group, train: Dataset,
                  scorer: MetricScorer, validation=None) -> None:
        """One rank's part of a data-parallel fit (``parallel.dp``): its
        shard of ``train``, the sweeps with ``group``."""
        self._sweeps(*self.prepare_fit(train, scorer, device,
                                       (rank, group)),
                     scorer, validation, device)

    def _sweeps(self, sweep, w, cur, order_T, buckets, scorer, validation,
                device) -> None:
        """The sweep loop, the best restart's weights renormalized in f64,
        and the validation line."""
        R = self.n_restart
        log(f"Training starts... [{self.NAME}] optimizing {scorer.name} "
            f"({R} restarts in lockstep)")
        for sweep_i in range(self.max_passes):
            w, cur, improved = sweep(w, cur, order_T, buckets)
            imp = improved.cpu().numpy()               # one read a sweep
            curs = cur.cpu().numpy()
            log(f"  pass {sweep_i + 1}: {scorer.name} = "
                f"{float(curs.max()):.4f} "
                f"({int(imp.sum())}/{R} restarts improving)")
            event("sweep", ranker=self.NAME, sweep=sweep_i + 1,
                  best_metric=float(curs.max()),
                  improving=int(imp.sum()))
            if not imp.any():
                break
        curs = cur.cpu().numpy().astype(np.float64)
        ws = w.cpu().numpy().astype(np.float64)
        best = int(np.argmax(curs))
        # the model file's Σ|w| = 1 holds at double precision
        wbest = ws[best]
        norm = np.abs(wbest).sum()
        self.weights = wbest / (norm if norm > 0 else 1.0)
        log("-" * 40)
        log(f"Finished successfully. {scorer.name} on training data: "
            f"{curs[best]:.4f}")
        if validation is not None:
            wv = self.weights[:, None].astype(np.float32)
            if wants_sparse_eval(validation):
                vc, vbk, vn = build_sparse_data(validation, device)
                with full_f32_products():
                    vm = sparse_mean_metric(
                        scorer, torch.from_numpy(wv).to(device), vc, vbk,
                        vn, len(validation.queries))[0]
            else:
                vm = LinearMetricEvaluator(validation, scorer,
                                           device).mean_metric(wv)[0]
            log(f"{scorer.name} on validation data: {float(vm):.4f}")

    def eval_dataset(self, ds: Dataset, device: torch.device):
        if self.weights is None:
            raise RankLibError("Model not trained/loaded")
        return linear_scores(ds, self.weights, device)

    def model_str(self) -> str:
        hdr = model_header(self.NAME, {
            "Restart": self.n_restart,
            "MaxIteration": self.n_max_iteration,
            "StepBase": self.STEP_BASE,
            "StepScale": self.STEP_SCALE,
            "Tolerance": self.tolerance,
            "Regularized": self.reg is not None,
            "Slack": self.reg if self.reg is not None else 0,
        })
        body = " ".join(f"{i + 1}:{self.weights[i]}"
                        for i in range(len(self.weights)))
        return hdr + body + "\n"

    def load_str(self, text: str) -> None:
        _, body = parse_model_params(text)
        if not body:
            raise RankLibError("Empty Coordinate Ascent model body")
        pairs = body[0].split()
        max_fid = max(int(p.split(":")[0]) for p in pairs)
        w = np.zeros(max_fid, np.float64)
        for p in pairs:
            fid, _, v = p.partition(":")
            w[int(fid) - 1] = float(v)
        self.weights = w
