"""MART (`-ranker 0`) and LambdaMART (`-ranker 6`): fit, score, save
(ranklib_tpu.models.gbdt; ref: learning/tree/LambdaMART.java,
learning/tree/MART.java).

* fit: flatten the docs, compute ≤ ``-tc`` candidate split values per
  feature and pre-bin; then one round per tree (``gbdt.boost``):
  pseudo-responses (lambda gradients for LambdaMART, residuals label −
  score for MART), a leaf-wise regression tree on them, leaf outputs
  (Newton Σλ/Σw for LambdaMART, mean residual for MART), scores +=
  shrinkage · tree(x);
* validation is scored every round; training stops after ``-estop``
  rounds without a validation gain and the ensemble is cut back to the
  best validation round.

Flags and defaults: ``-tree`` 1000, ``-leaf`` 10, ``-shrinkage`` 0.1,
``-tc`` 256, ``-mls`` 1, ``-estop`` 100. Dense input, or the streamed bin
matrix of ``-sparse`` (``data.binned.BinnedDataset``, trained
bit-identically to the dense path and scored in bin space).

The reference's extensions:

* warm start (``-resume``): a fit of a ranker that already holds trees
  (loaded, or a partial fit) seeds the scores with them and trains the
  ``n_trees − len(prior)`` rounds left; the model keeps the prior trees;
* ``-ckpt N`` (``ckpt_every``): every N rounds the model so far, prior
  trees included, is saved to ``ckpt_path``;
* a ``"round"`` event a round (``-eventlog``), unless silent;
* ``-dp n`` (``mesh``, ``parallel.dist``): one process a shard of the
  queries, the sums taken across the ranks (``gbdt.boost_dist``).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ranklib_tpu_torch.data.dataset import (
    Dataset, Query, flatten, flatten_meta,
)
from ranklib_tpu_torch.device import choose_device
from ranklib_tpu_torch.gbdt.binning import bin_features, compute_thresholds
from ranklib_tpu_torch.gbdt.boost import (
    init_state, make_boost_data, make_round_step,
)
from ranklib_tpu_torch.gbdt.ensemble import Tree, TreeEnsemble
from ranklib_tpu_torch.models.base import (
    Ranker, model_header, parse_model_params, register_ranker,
)
from ranklib_tpu_torch.utils.errors import RankLibError
from ranklib_tpu_torch.utils.logging import event, is_silent, log
from ranklib_tpu_torch.utils.trace import span


@register_ranker
class LambdaMART(Ranker):
    NAME = "LambdaMART"

    _NEWTON = True          # leaf output Σλ/Σw (MART: mean residual)
    _POINTWISE = False      # lambda gradients (MART: plain residuals)

    def __init__(self, **hp):
        self.n_trees = 1000
        self.n_leaves = 10
        self.learning_rate = 0.1
        self.n_threshold = 256
        self.min_leaf_support = 1
        self.early_stop = 100
        self.ckpt_every = 0          # save a checkpoint every N rounds
        self.ckpt_path = "model.ckpt"
        self.ensemble = TreeEnsemble()
        self.feature_impacts = None  # [F] deviance reduction, set by fit()
        self.fit_state = None        # the last fit's BoostState
        self.rank_launches = None    # the last -dp fit's, a dict a rank
        super().__init__(**hp)
        if self.n_leaves < 2:
            # a 1-leaf tree is a constant; growth assumes one split
            raise RankLibError(f"-leaf must be >= 2 (got {self.n_leaves})")

    def fit(self, train: Dataset, scorer, validation: Dataset | None = None,
            device: torch.device | None = None,
            feature_mask: np.ndarray | None = None, mesh=None,
            profile_dir: str | None = None) -> None:
        """Train on ``device`` (default: :func:`choose_device`'s, as the
        CLI picks it). ``feature_mask``: optional [F] bool, features
        outside it are never split on (``-feature`` on the streamed
        ``-sparse`` path). ``mesh``: a ``parallel.dist.Mesh``; of more
        than one rank, the data-parallel fit (ref ``fit``, :82), whose
        ranks write their profiler traces into ``profile_dir``."""
        device = choose_device(quiet=True) if device is None else device
        if mesh is not None and mesh.size > 1:
            return self._fit_distributed(train, scorer, validation, device,
                                         mesh, feature_mask, profile_dir)
        prior, rounds = self._prior()
        step, state, data, thresholds = self.prepare_fit(
            train, scorer, validation, device, feature_mask)
        log("Training starts...")
        self._boost_loop(step, state, data, scorer, validation is not None,
                         thresholds, prior, rounds)

    def _prior(self):
        """(the trees a fit continues, the rounds left): the ranker's own
        trees when it holds any (a loaded model, ``-resume``; ref ``fit``,
        :134-160), and the rounds up to ``n_trees``."""
        prior = self.ensemble if len(self.ensemble) else TreeEnsemble()
        return prior, max(0, self.n_trees - len(prior))

    def prepare_fit(self, train: Dataset, scorer, validation, device,
                    feature_mask=None):
        """Bin (or take the streamed bins), upload, build the round and
        seed a warm start's scores: (step, state, data, thresholds);
        ``step(state, t, data)`` runs round t."""
        with span("prepare"):
            return self._prepare_fit(train, scorer, validation, device,
                                     feature_mask)

    def _prepare_fit(self, train: Dataset, scorer, validation, device,
                     feature_mask):
        with span("prepare.bin"):
            feats, labels, _, thresholds, binned_real, N, F = \
                flatten_binned(train, self.n_threshold)
        with span("prepare.pad"):
            binned, labels_pad, Npad = pad_binned(feats, binned_real,
                                                  thresholds, labels, N)
        with span("prepare.validation_bins"):
            vfeats, vbinned = _validation_bins(validation, thresholds)
        data, Npad, Nvpad = make_boost_data(
            train, binned, labels_pad, N, validation, vbinned, device,
            feature_mask, scorer=None if self._POINTWISE else scorer)
        step = make_round_step(
            scorer, n_bins=thresholds.shape[1], n_leaves=self.n_leaves,
            min_leaf_support=self.min_leaf_support,
            learning_rate=self.learning_rate, pointwise=self._POINTWISE,
            newton=self._NEWTON, n_queries=len(train.queries),
            n_vqueries=(len(validation.queries) if validation is not None
                        else 1),
            # the per-round train metric only feeds the console table
            train_metric=not is_silent())
        prior, rounds = self._prior()
        state = init_state(rounds, self.n_leaves, Npad, Nvpad, F, device)
        if len(prior):
            sc, vsc = _prior_scores(prior, feats, binned_real, thresholds,
                                    vfeats, vbinned, device)
            state.scores[:N] = torch.from_numpy(sc.astype(np.float32)).to(
                device)
            if vsc is not None:
                state.vscores[:len(vsc)] = torch.from_numpy(
                    vsc.astype(np.float32)).to(device)
            log(f"Warm start from {len(prior)} trees ({rounds} rounds to "
                f"go)")
        return step, state, data, thresholds

    def _boost_loop(self, step, state, data, scorer, has_val: bool,
                    thresholds, prior: TreeEnsemble, rounds: int) -> None:
        """Round loop: console table and ``"round"`` events, checkpoints,
        early stop, best-round rollback, ensemble export (``prior``'s trees
        first). The host reads the device only for a table line (not
        silent), a checkpoint or an early-stop check."""
        head = f"{'#iter':<8}| {scorer.name + '-T':<11}"
        if has_val:
            head += f"| {scorer.name + '-V':<11}"
        log(head)
        silent = is_silent()
        # silent mode reads the validation history only every `check`
        # rounds; the replayed stop rule gives the same round either way
        check = 1 if not silent else max(1, min(self.early_stop or 50, 50))
        lr = self.learning_rate
        built = 0
        stopped = False
        for t in range(rounds):
            state = step(state, t, data)
            built = t + 1
            if not silent:
                with span("host_read"):
                    tm = float(state.train_m[t])
                    vm = float(state.val_m[t]) if has_val else None
                line = f"{built:<8}| {tm:<11.4f}"
                if has_val:
                    line += f"| {vm:<11.4f}"
                log(line)
                event("round", ranker=self.NAME, round=built,
                      train_metric=tm, val_metric=vm)
            if self.ckpt_every and built % self.ckpt_every == 0:
                self.ensemble = _export(state, built, thresholds, lr, prior)
                self.save(self.ckpt_path)
            if has_val and self.early_stop > 0 and built % check == 0:
                sr = _stop_round(_to_host(state.val_m[:built]),
                                 self.early_stop)
                if sr is not None:
                    built, stopped = sr, True
                    log(f"Early stop at round {built} "
                        f"(no validation gain in {self.early_stop} rounds)")
                    break
        if has_val and self.early_stop > 0 and built and not stopped:
            # the last rounds may not land on the check stride
            sr = _stop_round(_to_host(state.val_m[:built]),
                             self.early_stop)
            if sr is not None:
                built = sr
                log(f"Early stop at round {built} "
                    f"(no validation gain in {self.early_stop} rounds)")
        keep = built
        if has_val and built:
            # roll back to the best validation round (ref: LambdaMART
            # learn() post-loop ensemble truncation)
            keep = int(np.nanargmax(_to_host(state.val_m[:built]))) + 1
        self.ensemble = _export(state, keep, thresholds, lr, prior)
        self.fit_state = state
        # per-feature deviance reduction over all splits (ref: LambdaMART
        # impacts[], printed after training)
        self.feature_impacts = _to_host(state.impacts).astype(np.float64)
        if not silent and self.feature_impacts.any():
            top = np.argsort(-self.feature_impacts)[:10]
            log("-- Feature impacts (top 10, deviance reduced)")
            for f in top:
                if self.feature_impacts[f] <= 0:
                    break
                log(f"  Feature {f + 1} : {self.feature_impacts[f]:.6g}")

    def _fit_distributed(self, train: Dataset, scorer, validation, device,
                         mesh, feature_mask=None, profile_dir=None) -> None:
        """``-dp`` (ref ``_fit_distributed``, :307-386): the ranks
        (:func:`_fit_rank` of :meth:`rank_args`) take their shards and
        run the round loop; rank 0 prints (a joined process prints its
        own), writes the checkpoints and the events; :meth:`take_ranks`
        keeps the result."""
        from ranklib_tpu_torch.parallel.dist import run

        self.take_ranks(run(mesh, _fit_rank,
                            *self.rank_args(train, scorer, validation,
                                            device, mesh, feature_mask),
                            profile_dir=profile_dir))

    def rank_args(self, train: Dataset, scorer, validation, device, mesh,
                  feature_mask=None) -> tuple:
        """The arguments of :func:`_fit_rank` after its first three: the
        grid and the bins of the whole training set, made here (in every
        process of a joined mesh) and handed to the ranks of ``mesh``
        (shared memory, or a joined rank's own), and a warm start's
        scores."""
        feats, _, _, thresholds, binned, _, _ = flatten_binned(
            train, self.n_threshold)
        if binned is None:
            binned = bin_features(feats, thresholds)
        vfeats, vbinned = _validation_bins(validation, thresholds)
        prior, rounds = self._prior()
        init = vinit = None
        if len(prior):
            init, vinit = _prior_scores(prior, feats, binned, thresholds,
                                        vfeats, vbinned, device)
            log(f"Warm start from {len(prior)} trees ({rounds} rounds to "
                f"go)")
        log(f"Training starts... [data-parallel over {mesh.size} devices]")
        worker = copy.copy(self)
        worker.fit_state = worker.feature_impacts = None
        return (worker, labels_only(train), shared(binned, mesh), thresholds,
                labels_only(validation), shared(vbinned, mesh), feature_mask,
                scorer, init, vinit)

    def take_ranks(self, out: list) -> None:
        """Every rank's :func:`_fit_rank` result: the models must be
        equal; rank 0's is kept, with each rank's launch counts in
        ``rank_launches``."""
        check_same_models([ens for ens, _, _ in out])
        self.ensemble, self.feature_impacts, _ = out[0]
        self.rank_launches = [c for _, _, c in out]
        self.fit_state = None

    def fit_shard(self, rank: int, device, group, train: Dataset, binned,
                  thresholds, scorer, validation=None, vbinned=None,
                  feature_mask=None, init=None, vinit=None, qstart=None):
        """One rank's part of a data-parallel fit: its shard of ``train``
        (whose docs' bins are ``binned``, at ``qstart`` rows) and of
        ``validation``, the round loop with ``group``. ``init`` /
        ``vinit``: the warm start's scores of every doc (flatten order).
        Only rank 0 writes checkpoints."""
        from ranklib_tpu_torch.gbdt.boost_dist import (
            build_sharded_data, scatter_doc_values,
        )

        n = torch.distributed.get_world_size(group)
        data, Npad, Nvpad = build_sharded_data(
            train, binned, n, rank, device, validation, vbinned,
            feature_mask, scorer=None if self._POINTWISE else scorer,
            qstart=qstart)
        prior, rounds = self._prior()
        step = make_round_step(
            scorer, n_bins=thresholds.shape[1],
            n_leaves=self.n_leaves, min_leaf_support=self.min_leaf_support,
            learning_rate=self.learning_rate, pointwise=self._POINTWISE,
            newton=self._NEWTON, n_queries=len(train.queries),
            n_vqueries=(len(validation.queries) if validation is not None
                        else 1),
            train_metric=not is_silent(), group=group)
        state = init_state(rounds, self.n_leaves, Npad, Nvpad,
                           binned.shape[1], device)
        if init is not None:
            state.scores.copy_(torch.from_numpy(
                scatter_doc_values(train, init, n, rank, Npad)))
        if vinit is not None:
            state.vscores.copy_(torch.from_numpy(
                scatter_doc_values(validation, vinit, n, rank, Nvpad)))
        if rank != 0:
            self.ckpt_every = 0
        self._boost_loop(step, state, data, scorer, validation is not None,
                         thresholds, prior, rounds)

    def eval_dataset(self, ds: Dataset, device: torch.device):
        if not len(self.ensemble):
            raise RankLibError("Model not trained/loaded")
        return eval_ensemble_dataset(self.ensemble, ds, device)

    def model_str(self) -> str:
        return model_header(self.NAME, {
            "No. of trees": len(self.ensemble),
            "No. of leaves": self.n_leaves,
            "No. of threshold candidates": self.n_threshold,
            "Learning rate": self.learning_rate,
            "Stop early": self.early_stop,
        }) + "\n" + self.ensemble.to_text()

    def load_str(self, text: str) -> None:
        params, _ = parse_model_params(text)
        try:
            if "No. of leaves" in params:
                self.n_leaves = int(params["No. of leaves"])
            if "Learning rate" in params:
                self.learning_rate = float(params["Learning rate"])
            if "No. of trees" in params:
                self.n_trees = int(params["No. of trees"])
        except ValueError as e:
            raise RankLibError(f"Bad model header value: {e}") from None
        self.ensemble = TreeEnsemble.from_text(text)


@register_ranker
class MART(LambdaMART):
    """Pointwise GBRT: pseudo-responses are plain residuals and leaf
    outputs mean residuals (ref: learning/tree/MART.java:~15); the same
    model and file format."""

    NAME = "MART"
    _NEWTON = False
    _POINTWISE = True


def _fit_rank(rank, device, group, ranker, train, binned, thresholds,
              validation, vbinned, feature_mask, scorer, init, vinit):
    """A ``-dp`` rank of :meth:`LambdaMART._fit_distributed`: (its model,
    its feature impacts, its :func:`launch_counts` over the fit)."""
    before = launch_counts()
    ranker.fit_shard(rank, device, group, train, binned.numpy(), thresholds,
                     scorer, validation,
                     None if vbinned is None else vbinned.numpy(),
                     feature_mask, init, vinit)
    return (ranker.ensemble, ranker.feature_impacts,
            launches_since(before))


def launch_counts() -> dict:
    """This process's launch counts of the kernels a tree fit runs (a
    ``-dp`` rank returns them with its model)."""
    from ranklib_tpu_torch.ops.forest_eval import forest_eval_frombins
    from ranklib_tpu_torch.ops.histogram import histogram, histogram_multi
    from ranklib_tpu_torch.ops.lambda_kernel import lambda_round
    from ranklib_tpu_torch.ops.split_scan import best_splits

    return {"histogram": histogram.launches,
            "histogram_multi": histogram_multi.launches,
            "split_scan": best_splits.launches,
            "lambda_pairs": lambda_round.launches,
            "forest_eval_frombins": forest_eval_frombins.launches}


def launches_since(before: dict) -> dict:
    """This process's :func:`launch_counts` since ``before`` (a joined
    process runs several fits)."""
    return {k: v - before[k] for k, v in launch_counts().items()}


def labels_only(ds: Dataset | None) -> Dataset | None:
    """``ds`` without its feature values (what a ``-dp`` rank is sent:
    its bins travel in shared memory)."""
    if ds is None:
        return None
    return Dataset([Query(q.qid, q.labels, None) for q in ds.queries],
                   ds.n_features)


def shared(a: np.ndarray | None, mesh) -> torch.Tensor | None:
    """A host array for the ranks of ``mesh``: in shared memory, which
    spawned ranks map and none copies; a joined process's own array as it
    is (its ranks are itself)."""
    if a is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if mesh.joined else t.share_memory_()


def check_same_models(ensembles) -> None:
    """Every ``-dp`` rank must end with the same trees: they took the same
    decisions on the same summed statistics."""
    if len({e.to_text() for e in ensembles}) != 1:
        raise RankLibError("the -dp ranks ended with different models")


def _validation_bins(validation: Dataset | None, thresholds):
    """(raw values or None, bins on the training grid) of a validation
    set; a streamed one brings its bins and no raw values."""
    if validation is None:
        return None, None
    if getattr(validation, "binned", None) is not None:
        return None, validation.binned
    vfeats = flatten(validation)[0]
    return vfeats, bin_features(vfeats, thresholds)


def _prior_scores(prior: TreeEnsemble, feats, binned, thresholds, vfeats,
                  vbinned, device):
    """The warm start's scores of the training docs and of the validation
    docs (None without validation; ref ``fit``, :145-160): from the raw
    values where there are any, else in bin space (exact on this grid)."""
    ens_bin = None
    if feats is not None:
        sc = prior.eval_matrix(feats, device)
    else:
        ens_bin = prior.to_bin_space(thresholds)
        sc = _eval_binned(ens_bin, binned, device)
    if vbinned is None:
        return sc, None
    if vfeats is not None:
        return sc, prior.eval_matrix(vfeats, device)
    if ens_bin is None:
        ens_bin = prior.to_bin_space(thresholds)
    return sc, _eval_binned(ens_bin, vbinned, device)


def eval_ensemble_dataset(ensemble: TreeEnsemble, ds: Dataset,
                          device: torch.device):
    """Per-query scores of a TreeEnsemble (ref ``eval_ensemble_dataset``,
    :434), shared by the GBDT family and Random Forests: a streamed
    ``BinnedDataset`` in bin space (:func:`_eval_binned`; exact for a model
    trained on its grid); a CSR dataset in bounded dense chunks through
    ``eval_matrix``; a dense one flattened, its width padded to the
    model's largest fid, in one ``eval_matrix`` call."""
    max_fid = 1 + max(int(t.feature.max()) for t in ensemble.trees)
    if getattr(ds, "binned", None) is not None:
        flat = _eval_binned(ensemble.to_bin_space(ds.thresholds), ds.binned,
                            device)
        _, qptr = flatten_meta(ds)
    elif hasattr(ds, "materialize_rows"):
        from ranklib_tpu_torch.data.sparse import _chunk_bytes

        F = max(ds.n_features, max_fid)
        rows = max(1, _chunk_bytes() // (F * 4))
        N = ds.n_docs
        flat = np.concatenate([
            ensemble.eval_matrix(
                ds.materialize_rows(lo, min(lo + rows, N), width=F), device)
            for lo in range(0, N, rows)])
        _, qptr = flatten_meta(ds)
    else:
        feats, _, qptr = flatten(ds)
        if feats.shape[1] < max_fid:
            feats = np.pad(feats, ((0, 0), (0, max_fid - feats.shape[1])))
        flat = ensemble.eval_matrix(feats, device)
    return [flat[qptr[i]: qptr[i + 1]] for i in range(len(ds.queries))]


def _eval_binned(ens_bin: TreeEnsemble, bins: np.ndarray,
                 device: torch.device, chunk: int = 1 << 18) -> np.ndarray:
    """Scores of a bin-space ensemble (:meth:`TreeEnsemble.to_bin_space`)
    over an int16 bin matrix (ref ``_eval_binned``): the ids cast to f32
    in doc chunks, so no second full-size matrix is held, each through
    ``eval_matrix`` (on the card the frombins kernel)."""
    out = np.empty(bins.shape[0], np.float64)
    for lo in range(0, bins.shape[0], chunk):
        hi = min(lo + chunk, bins.shape[0])
        out[lo:hi] = ens_bin.eval_matrix(bins[lo:hi].astype(np.float32),
                                         device)
    return out


def _stop_round(hist: np.ndarray, estop: int):
    """Replay the reference's per-round early-stop rule over a validation
    history: stop after the FIRST round t (1-based return) with
    t − best_so_far >= estop, ties keeping the earliest best (the
    reference's strict ``>`` improvement test). Returns the 1-based round
    count to cut training to, or None."""
    best = 0
    for t in range(len(hist)):
        if not np.isnan(hist[t]) and (np.isnan(hist[best])
                                      or hist[t] > hist[best]):
            best = t
        if t - best >= estop:
            return t + 1
    return None


def flatten_binned(train: Dataset, n_threshold: int):
    """The fit preamble (ref ``flatten_binned``): (feats [N, F] or None,
    labels [N], qptr [Q+1], thresholds [F, B], binned [N, F] or None, N,
    F). A streamed ``-sparse`` dataset brings its bin matrix and grid and
    no raw values; dense data takes its grid from the real docs only."""
    if getattr(train, "binned", None) is not None:
        labels, qptr = flatten_meta(train)
        N, F = train.binned.shape
        return None, labels, qptr, train.thresholds, train.binned, N, F
    feats, labels, qptr = flatten(train)
    N, F = feats.shape
    thresholds, _ = compute_thresholds(feats, n_threshold)
    return feats, labels, qptr, thresholds, None, N, F


def pad_binned(feats, binned_real, thresholds, labels, N: int):
    """Pad the doc axis to :func:`_pad_doc_count`. Dense data bins after
    padding (pad rows bin wherever 0.0 lands), pre-binned data pads with
    bin 0; pad docs weigh 0 either way, so they are inert. Returns
    (binned [Npad, F], labels_pad [Npad] f32, Npad)."""
    Npad = _pad_doc_count(N)
    if binned_real is None:
        binned = bin_features(np.pad(feats, ((0, Npad - N), (0, 0))),
                              thresholds)
    else:
        binned = np.pad(binned_real, ((0, Npad - N), (0, 0)))
    labels_pad = np.pad(labels, (0, Npad - N)).astype(np.float32)
    return binned, labels_pad, Npad


def _pad_doc_count(n: int) -> int:
    """The reference's quantized doc count (256, powers of two below 4096,
    then multiples of 4096): pad docs are inert, and the same count keeps
    the two packages' pad docs, tie breaks and shapes alike."""
    if n <= 256:
        return 256
    if n < 4096:
        p = 256
        while p < n:
            p *= 2
        return p
    return ((n + 4095) // 4096) * 4096


def _export_tree(feature, sbin, left, right, is_leaf, out, n_nodes,
                 thresholds) -> Tree:
    """Tree slots (host arrays) → a Tree with real threshold floats."""
    n = max(n_nodes, 1)
    feature = feature[:n]
    sbin = sbin[:n]
    is_leaf = is_leaf[:n]
    internal = (~is_leaf) & (feature >= 0)
    thr = np.zeros(n, np.float32)
    thr[internal] = thresholds[feature[internal], sbin[internal]]
    return Tree(feature=np.maximum(feature, 0), threshold=thr,
                left=left[:n], right=right[:n], is_leaf=is_leaf,
                output=out[:n])


def _to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` read back to the host, inside a ``host_read`` span."""
    with span("host_read"):
        return t.cpu().numpy()


def _export(state, keep: int, thresholds, weight: float,
            prior: TreeEnsemble | None = None) -> TreeEnsemble:
    """``prior``'s trees, then the first ``keep`` recorded trees, as a
    TreeEnsemble (one read of the records)."""
    with span("host_read"):
        arrs = [a[:keep].cpu().numpy() for a in (
            state.tfeat, state.tbin, state.tleft, state.tright, state.tleaf,
            state.tout, state.tnodes)]
    ens = TreeEnsemble()
    if prior is not None:
        for tree, w in zip(prior.trees, prior.weights):
            ens.add(tree, w)
    for i in range(keep):
        ens.add(_export_tree(*(a[i] for a in arrs[:6]), int(arrs[6][i]),
                             thresholds), weight)
    return ens
