"""RankBoost (`-ranker 2`; ranklib_tpu.models.rankboost; ref:
learning/boosting/RankBoost.java, RBWeakRanker.java).

Pairwise boosting over every (winner, loser) document pair with a
distribution D over pairs. A round picks the binary weak ranker
(feature f, threshold θ; q(d) = 1 iff value > θ) maximizing
r = Σ D(x, y)(q(x) − q(y)), weighs it α = ½ln((1 + r)/(1 − r)) and moves
D toward the pairs it orders wrongly. The final score is
H(d) = Σ α_t q_t(d). Candidate thresholds: ``-tc`` (10) evenly spaced
values between a feature's min and max.

D is never stored: the multiplicative updates telescope to
D(x, y) ∝ exp(−(H(x) − H(y))), so the round's pair potential
π(d) = Σ_y D(d, y) − Σ_x D(x, d) and the normalizer Z are sums of
exponentials per (query, label level), O(N·L). A per-query midrange shift
of H, which cancels inside every pair product, bounds the f32 exponents.
The weak search histograms π by (feature, bin) — bin = the number of
thresholds below the value, T + 1 bins — with ``ops.histogram`` (the
CUDA kernel on the card), then r(f, t) = Σ_{b > t} hist[f, b] is a
reversed cumulative sum and the pick a first argmax.

A round runs on the device and reads nothing back; the weak rankers are
read once after the fit. The console table reads a round's metrics when
it prints them. Flags: ``-round`` 300, ``-tc`` 10.

A ``-sparse`` CSR file bins in bounded row chunks (:func:`bin_csr_chunks`)
straight into the device's ``[F, N]`` ids, the same ids as the dense
file's, so the fit is the same.

Under ``-dp`` (``mesh``, ``parallel.dp``) the grid and the ids of every
document are computed once, here, from the whole training set (a grid
taken from a rank's shard would differ from its peers'); each rank maps
the ids from shared memory, takes its queries' rows and runs the round
on them with its process group: Z, the weak search's ``[F, T + 1]``
histogram (one ``ops.histogram`` launch a round a rank) and the metric
sums are summed across the ranks, and the pick, α and the record are
the same on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ranklib_tpu_torch.data.dataset import Dataset, flatten
from ranklib_tpu_torch.device import choose_device
from ranklib_tpu_torch.gbdt.binning import bin_features
from ranklib_tpu_torch.gbdt.boost import (
    _bucket_metric_sum, _host_buckets, _upload, round_capacity,
    run_silent_rounds,
)
from ranklib_tpu_torch.gbdt.grow import sum_across
from ranklib_tpu_torch.metrics.base import MetricScorer
from ranklib_tpu_torch.models.base import (
    Ranker, model_header, parse_model_params, register_ranker,
)
from ranklib_tpu_torch.ops.batched_eval import blockwise_scores
from ranklib_tpu_torch.ops.histogram import histogram
from ranklib_tpu_torch.utils.errors import RankLibError
from ranklib_tpu_torch.utils.logging import event, is_silent, log


def bin_dtype(T: int):
    """Narrowest signed dtype holding bins in [0, T]: int16, or int32 when
    -tc ≥ 32767 would wrap it."""
    return np.int16 if T < np.iinfo(np.int16).max else np.int32


def threshold_grid(feats: np.ndarray, T: int) -> np.ndarray:
    """``[F, T]`` f32: T evenly spaced thresholds strictly inside each
    feature's [min, max] (a constant feature's all equal, never a useful
    split)."""
    return _grid(feats.min(axis=0), feats.max(axis=0), T)


def _grid(lo: np.ndarray, hi: np.ndarray, T: int) -> np.ndarray:
    return lo[:, None] + (hi - lo)[:, None] * (
        np.arange(1, T + 1, dtype=np.float32)[None, :] / (T + 1))


def bin_csr_chunks(ds, T: int, device: torch.device,
                   grid: np.ndarray | None = None):
    """(grid, ``[F, N]`` bins on ``device``) of a CSR dataset, in row chunks
    of ``RANKLIB_TPU_SPARSE_CHUNK_MB`` (ref: ``RankBoost._bin_csr_chunks``).
    Two passes: min/max over the materialized rows, implicit zeros
    included, so the grid is the dense pipeline's bit for bit; then each
    chunk's bins go up into their columns. ``grid``: bin on a given grid
    (validation on the training grid). The host holds one chunk: in the
    binning pass its f32 rows, their int32 and int16 bins and the
    transposed copy (12 B a value), so ``[N, F]`` never lands on the
    host."""
    N, F = ds.n_docs, ds.n_features
    if grid is None:
        grid = csr_grid(ds, T)
    bdt = bin_dtype(T)
    binned_T = torch.empty((F, N), dtype=(
        torch.int16 if bdt == np.int16 else torch.int32), device=device)
    for s, e, b in _csr_bin_chunks(ds, grid, bdt):
        binned_T[:, s:e] = torch.from_numpy(np.ascontiguousarray(b.T)).to(
            device)
        del b
    return grid, binned_T


def csr_grid(ds, T: int) -> np.ndarray:
    """:func:`threshold_grid` of a CSR dataset, from min/max over its
    materialized row chunks (implicit zeros included)."""
    from ranklib_tpu_torch.data.sparse import _chunk_bytes

    N, F = ds.n_docs, ds.n_features
    rows = max(1, _chunk_bytes() // (max(1, F) * 4))
    lo = np.full(F, np.inf, np.float32)
    hi = np.full(F, -np.inf, np.float32)
    for s in range(0, N, rows):
        X = ds.materialize_rows(s, min(s + rows, N))
        np.minimum(lo, X.min(axis=0), out=lo)
        np.maximum(hi, X.max(axis=0), out=hi)
    return _grid(lo, hi, T)


def _csr_bin_chunks(ds, grid: np.ndarray, bdt):
    """(start, end, ``[end - start, F]`` ids) of a CSR dataset's row
    chunks on ``grid``."""
    from ranklib_tpu_torch.data.sparse import _chunk_bytes

    N, F = ds.n_docs, ds.n_features
    rows = max(1, _chunk_bytes() // (max(1, F) * 4) // 3)
    for s in range(0, N, rows):
        e = min(s + rows, N)
        yield s, e, bin_features(ds.materialize_rows(s, e), grid).astype(bdt)


def host_bins(ds, T: int, grid: np.ndarray | None = None):
    """(grid, ``[N, F]`` ids) of a dense or CSR dataset on the host, the
    ids at :func:`bin_dtype` (a ``-dp`` fit's, shared by its ranks)."""
    bdt = bin_dtype(T)
    if hasattr(ds, "materialize_rows"):
        if grid is None:
            grid = csr_grid(ds, T)
        out = np.empty((ds.n_docs, ds.n_features), bdt)
        for s, e, b in _csr_bin_chunks(ds, grid, bdt):
            out[s:e] = b
        return grid, out
    feats = flatten(ds)[0]
    if grid is None:
        grid = threshold_grid(feats, T)
    return grid, bin_features(feats, grid).astype(bdt, copy=False)


@dataclass
class RBData:
    """Per-fit device tensors."""

    binned_T: torch.Tensor   # [F, N] int16/int32, bin = #thresholds < value
    ones: torch.Tensor       # [N] bool, the weak search's histogram mask
    tb: list                 # train chunks: (labels, mask, didx → N pads)
    uniq: torch.Tensor       # [L] f32 sorted distinct label values
    vq_T: torch.Tensor       # [F, Nv] validation bins on the same grid
    vb: list                 # validation chunks (may be empty)


@dataclass
class RBState:
    """Scores (which imply the pair distribution) and the weak-ranker
    record; updated in place."""

    scores: torch.Tensor     # [N + 1] f32 (slot N takes the pads)
    vscores: torch.Tensor    # [Nv + 1] f32
    wf: torch.Tensor         # [CAP] int64 picked feature
    wt: torch.Tensor         # [CAP] int64 picked threshold index
    walpha: torch.Tensor     # [CAP] f32
    wact: torch.Tensor       # [CAP] bool (False once degenerate)
    active: torch.Tensor     # [] bool
    train_m: torch.Tensor    # [CAP] f32 (NaN until written)
    val_m: torch.Tensor      # [CAP] f32


def pair_potential(scores: torch.Tensor, tb: list, uniq: torch.Tensor,
                   N: int, group=None) -> torch.Tensor:
    """π over the N documents, normalized by Z (≥ 1e-30): per query,

    π(d) = e^{−H̃(d)}·Σ_{lab < lab(d)} e^{H̃}
           − e^{H̃(d)}·Σ_{lab > lab(d)} e^{−H̃}

    with H̃ = H − midrange_q(H), and Z = Σ over winners of the first term
    (summed across ``group``'s ranks under ``-dp``)."""
    L = uniq.shape[0]
    pot = torch.zeros(N + 1, dtype=torch.float32, device=scores.device)
    Z = torch.zeros((), dtype=torch.float32, device=scores.device)
    for lab, msk, didx in tb:
        H = scores[didx]                                       # [Bc, D]
        mf = msk.to(torch.float32)
        hmax = torch.where(msk, H, -torch.inf).amax(dim=1, keepdim=True)
        hmin = torch.where(msk, H, torch.inf).amin(dim=1, keepdim=True)
        c = torch.where(torch.isfinite(hmax), 0.5 * (hmax + hmin), 0.0)
        Ht = (H - c) * mf
        e_pos = torch.exp(Ht) * mf
        e_neg = torch.exp(-Ht) * mf
        # label values come verbatim from uniq's f32 source: exact ranks
        lv = torch.clamp(torch.searchsorted(uniq, lab), 0, L - 1)
        oh = (lv[..., None] == torch.arange(L, device=lv.device)).to(
            torch.float32) * mf[..., None]
        S = (oh * e_pos[..., None]).sum(dim=1)                 # [Bc, L]
        Tn = (oh * e_neg[..., None]).sum(dim=1)
        # exclusive prefix (levels below) and suffix (levels above)
        Wc = torch.cumsum(S, dim=1) - S
        Lc = Tn.sum(dim=1, keepdim=True) - torch.cumsum(Tn, dim=1)
        win = torch.gather(Wc, 1, lv) * mf
        lose = torch.gather(Lc, 1, lv) * mf
        Z = Z + (e_neg * win).sum()
        pot.index_add_(0, didx.reshape(-1),
                       (e_neg * win - e_pos * lose).reshape(-1))
    return pot[:N] / torch.clamp(sum_across(Z, group), min=1e-30)


def weak_search(binned_T: torch.Tensor, pot: torch.Tensor,
                ones: torch.Tensor, T: int, group=None):
    """(hist [F, T+1], r_all [F, T+1]): the histogram of π by (feature,
    bin) — one ``ops.histogram`` call at B = T + 1, summed across
    ``group``'s ranks under ``-dp`` — and r(f, t) = Σ_{b > t} hist[f, b],
    with the always-zero column t = T."""
    hist = histogram(binned_T, pot, ones, T + 1)[..., 0]
    if group is not None:
        hist = sum_across(hist.contiguous(), group)
    rev = torch.flip(torch.cumsum(torch.flip(hist, [1]), dim=1), [1])
    r_all = torch.cat([rev[:, 1:], torch.zeros_like(rev[:, :1])], dim=1)
    return hist, r_all


def make_rb_step(scorer, *, n_thresholds: int, n_queries: int,
                 n_vqueries: int, has_val: bool, train_metric: bool = True,
                 group=None):
    """The round: ``step(state, t, data) → state``, on the data's device,
    with no host sync. ``has_val``: a validation set exists (on every
    rank alike, whether or not this rank's shard of it holds a query).
    ``train_metric=False`` skips the train metric, which only feeds the
    console table. ``group``: a ``-dp`` rank's process group (the query
    counts are then global)."""
    T = n_thresholds

    def step(state: RBState, t: int, data: RBData) -> RBState:
        N = data.binned_T.shape[1]
        pot = pair_potential(state.scores, data.tb, data.uniq, N, group)
        _, r_all = weak_search(data.binned_T, pot, data.ones, T, group)
        flat = r_all.reshape(-1)
        idx = torch.argmax(flat)                               # first max
        f_s = idx // (T + 1)
        t_s = idx % (T + 1)
        r = torch.clamp(flat.gather(0, idx.view(1))[0], -0.999999, 0.999999)
        # t_s == T: the zero column won, no real candidate has r > 0; r ==
        # 0 gives α = 0 forever. Either way this and every later round
        # deactivate, and the fit keeps the rounds before.
        active = state.active & (t_s < T) & (r > 0)
        alpha = torch.where(active, 0.5 * torch.log((1.0 + r) / (1.0 - r)),
                            0.0)
        q = data.binned_T.index_select(0, f_s.view(1))[0] > t_s
        state.scores[:-1] += alpha * q.to(torch.float32)
        if train_metric:
            state.train_m[t] = (_bucket_metric_sum(
                scorer, data.tb, state.scores, group) / n_queries)
        # every rank takes part in the validation sum, an empty shard
        # with zeros: whether a rank calls a collective never depends on
        # its own shard
        if has_val:
            vq = data.vq_T.index_select(0, f_s.view(1))[0] > t_s
            state.vscores[:-1] += alpha * vq.to(torch.float32)
            state.val_m[t] = (_bucket_metric_sum(
                scorer, data.vb, state.vscores, group) / n_vqueries)
        state.wf[t] = f_s
        state.wt[t] = t_s
        state.walpha[t] = alpha
        state.wact[t] = active
        state.active = active
        return state

    return step


def _n_queries(ds) -> int:
    return len(ds.queries) if ds is not None else 1


def label_levels(train: Dataset) -> np.ndarray:
    """The sorted distinct f32 label values (the pair levels); refuses data
    without a correctly ordered pair. The initial D, uniform over those
    pairs, is H = 0: they are counted only to refuse data that has
    none."""
    uniq = np.unique(np.concatenate(
        [q.labels.astype(np.float32) for q in train.queries]))
    n_pairs = 0
    for q in train.queries:
        _, cnt = np.unique(q.labels.astype(np.float32), return_counts=True)
        n_pairs += int((cnt * (np.cumsum(cnt) - cnt)).sum())
    if n_pairs == 0:
        raise RankLibError("RankBoost: no correctly-ordered pairs in data")
    return uniq


@register_ranker
class RankBoost(Ranker):
    NAME = "RankBoost"
    MODEL_FIELDS = ("weaks",)          # what a -dp fit takes from rank 0

    def __init__(self, **hp):
        self.n_rounds = 300
        self.n_threshold = 10
        self.weaks: list[tuple[int, float, float]] = []  # (fid, θ, α)
        self.fit_state = None        # the last fit's RBState
        self.rank_launches = None    # the last -dp fit's, a dict a rank
        super().__init__(**hp)

    def prepare_fit(self, train: Dataset, scorer: MetricScorer, validation,
                    device):
        """Bin, upload and build the round: (step, state, data, grid);
        ``step(state, t, data)`` runs round t."""
        T = int(self.n_threshold)

        def upload_T(b):
            return torch.from_numpy(np.ascontiguousarray(b.T)).to(device)

        if hasattr(train, "materialize_rows"):
            grid, binned_T = bin_csr_chunks(train, T, device)
        else:
            grid, b = host_bins(train, T)
            binned_T = upload_T(b)
            del b
        uniq = label_levels(train)
        vq_T = None
        if validation is not None:
            if hasattr(validation, "materialize_rows"):
                vq_T = bin_csr_chunks(validation, T, device, grid)[1]
            else:
                vq_T = upload_T(host_bins(validation, T, grid)[1])
        step, state, data = self._build(scorer, train, validation, binned_T,
                                        vq_T, uniq, device,
                                        len(train.queries),
                                        _n_queries(validation))
        return step, state, data, grid

    def _build(self, scorer, train, validation, binned_T, vq_T, uniq,
               device, n_q: int, n_vq: int, group=None):
        """(step, state, data) of ``train``'s and ``validation``'s ids
        (``[F, N]``, ``[F, Nv]`` on ``device``); ``n_q``/``n_vq``: the
        query counts of the means (global under ``-dp``)."""
        N, F = train.n_docs, train.n_features
        Nv, vb = 0, []
        if validation is not None:
            Nv = validation.n_docs
            vb = _upload(_host_buckets(validation, Nv), device)
        else:
            vq_T = torch.zeros((F, 0), dtype=torch.int32, device=device)
        data = RBData(
            binned_T=binned_T,
            ones=torch.ones(N, dtype=torch.bool, device=device),
            tb=_upload(_host_buckets(train, N), device),
            uniq=torch.from_numpy(uniq).to(device), vq_T=vq_T, vb=vb)
        step = make_rb_step(
            scorer, n_thresholds=int(self.n_threshold), n_queries=n_q,
            n_vqueries=n_vq, has_val=validation is not None,
            train_metric=not is_silent(), group=group)
        CAP = round_capacity(self.n_rounds)
        f32 = dict(dtype=torch.float32, device=device)
        i64 = dict(dtype=torch.int64, device=device)
        state = RBState(
            scores=torch.zeros(N + 1, **f32),
            vscores=torch.zeros(Nv + 1, **f32),
            wf=torch.zeros(CAP, **i64), wt=torch.zeros(CAP, **i64),
            walpha=torch.zeros(CAP, **f32),
            wact=torch.zeros(CAP, dtype=torch.bool, device=device),
            active=torch.ones((), dtype=torch.bool, device=device),
            train_m=torch.full((CAP,), torch.nan, **f32),
            val_m=torch.full((CAP,), torch.nan, **f32))
        return step, state, data

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
        step, state, data, grid = self.prepare_fit(train, scorer, validation,
                                                   device)
        self._rounds(step, state, data, grid, scorer, validation is not None)

    def dp_job(self, mesh, train: Dataset, scorer: MetricScorer,
               validation=None):
        """The ``parallel.dp.ShardJob`` of this fit on ``mesh``: the grid
        and every document's ids (training and validation) from the whole
        sets, the ids in shared memory for spawned ranks; no feature
        values."""
        from ranklib_tpu_torch.models.gbdt import shared
        from ranklib_tpu_torch.parallel.dp import make_job

        T = int(self.n_threshold)
        grid, binned = host_bins(train, T)
        vbinned = (host_bins(validation, T, grid)[1]
                   if validation is not None else None)
        return make_job(self, mesh, train, scorer, validation,
                        features=False, grid=grid, uniq=label_levels(train),
                        binned=shared(binned, mesh),
                        vbinned=shared(vbinned, mesh))

    def fit_shard(self, rank: int, device, group, train: Dataset,
                  scorer: MetricScorer, validation, grid, uniq, binned,
                  vbinned) -> None:
        """One rank's part of a data-parallel fit (``parallel.dp``): the
        rows of ``binned`` / ``vbinned`` (every document's ids, in shared
        memory) of its shard of ``train`` / ``validation``, the rounds
        with ``group``."""
        from ranklib_tpu_torch.gbdt.boost_dist import _shard_arrays

        n = torch.distributed.get_world_size(group)

        def shard(ds, b):
            sub, rows = _shard_arrays(ds, b.numpy(), n, rank)
            return sub, torch.from_numpy(np.ascontiguousarray(rows.T)).to(
                device)

        sub, binned_T = shard(train, binned)
        vsub = vq_T = None
        if validation is not None:
            vsub, vq_T = shard(validation, vbinned)
        step, state, data = self._build(
            scorer, sub, vsub, binned_T, vq_T, uniq, device,
            len(train.queries), _n_queries(validation), group)
        self._rounds(step, state, data, grid, scorer, validation is not None)

    def _rounds(self, step, state, data, grid, scorer, has_val: bool) -> None:
        """The round loop (console table and ``"round"`` events) and the
        weak rankers, cut back to the best validation round."""
        log("Training starts...")
        head = f"{'#iter':<8}| {scorer.name + '-T':<11}"
        if has_val:
            head += f"| {scorer.name + '-V':<11}"
        log(head)
        silent = is_silent()
        if silent:
            state = run_silent_rounds(step, state, self.n_rounds, data)
        for t in ([] if silent else range(self.n_rounds)):
            state = step(state, t, data)
            if not bool(state.wact[t]):
                log(f"Stop at round {t + 1}: no useful weak ranker")
                break
            tm = float(state.train_m[t])
            line = f"{t + 1:<8}| {tm:<11.4f}"
            vm = None
            if has_val:
                vm = float(state.val_m[t])
                line += f"| {vm:<11.4f}"
            log(line)
            event("round", ranker=self.NAME, round=t + 1,
                  train_metric=tm, val_metric=vm)
        self.fit_state = state
        # one read of the whole record
        wf, wt, walpha, wact, val_m = (a.cpu().numpy() for a in (
            state.wf, state.wt, state.walpha, state.wact, state.val_m))
        built = 0
        for t in range(self.n_rounds):
            if not wact[t]:
                break
            built = t + 1
        keep = built
        if has_val and built:
            keep = int(np.nanargmax(val_m[:built])) + 1
        self.weaks = [(int(wf[t]) + 1, float(grid[wf[t], wt[t]]),
                       float(walpha[t])) for t in range(keep)]

    def eval_dataset(self, ds: Dataset, device: torch.device):
        """H(d) = Σ_t α_t·[v_{f_t}(d) > θ_t], on ``device`` in f32."""
        if not self.weaks:
            raise RankLibError("Model not trained/loaded")
        F = ds.n_features
        fids = np.array([min(w[0] - 1, F - 1) for w in self.weaks])
        inrange = np.array([w[0] <= F for w in self.weaks], np.float32)
        thetas = np.array([w[1] for w in self.weaks], np.float32)
        alphas = np.array([w[2] for w in self.weaks], np.float32) * inrange
        fids, thetas, alphas = (torch.from_numpy(a).to(device)
                                for a in (fids, thetas, alphas))
        return blockwise_scores(ds, lambda X: torch.matmul(
            (X[:, fids] > thetas).to(torch.float32), alphas), device)

    def model_str(self) -> str:
        head = model_header(self.NAME, {
            "Iteration": self.n_rounds,
            "No. of threshold candidates": self.n_threshold,
        })
        body = "\n".join(f"{fid}:{theta}:{alpha}"
                         for fid, theta, alpha in self.weaks)
        return head + body + "\n"

    def load_str(self, text: str) -> None:
        _, body = parse_model_params(text)
        self.weaks = []
        for line in body:
            for tok in line.split():
                fid, theta, alpha = tok.split(":")
                self.weaks.append((int(fid), float(theta), float(alpha)))
        if not self.weaks:
            raise RankLibError("Empty RankBoost model body")
