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
``-tc`` 256, ``-mls`` 1, ``-estop`` 100. Dense input on one device; warm
starts, checkpoints, ``-sparse`` and data parallelism are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ranklib_tpu_torch.data.dataset import Dataset, flatten
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
from ranklib_tpu_torch.utils.logging import is_silent, log


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
        self.ensemble = TreeEnsemble()
        self.feature_impacts = None  # [F] deviance reduction, set by fit()
        self.fit_state = None        # the last fit's BoostState
        super().__init__(**hp)
        if self.n_leaves < 2:
            # a 1-leaf tree is a constant; growth assumes one split
            raise RankLibError(f"-leaf must be >= 2 (got {self.n_leaves})")

    def fit(self, train: Dataset, scorer, validation: Dataset | None = None,
            device: torch.device | None = None) -> None:
        """Train on ``device`` (default: :func:`choose_device`'s, as the
        CLI picks it)."""
        device = choose_device(quiet=True) if device is None else device
        step, state, data, thresholds = self.prepare_fit(
            train, scorer, validation, device)
        log("Training starts...")
        self._boost_loop(step, state, data, scorer, validation is not None,
                         thresholds)

    def prepare_fit(self, train: Dataset, scorer, validation, device):
        """Bin, upload and build the round: (step, state, data,
        thresholds); ``step(state, t, data)`` runs round t."""
        feats, labels, _, thresholds, N, F = flatten_binned(
            train, self.n_threshold)
        binned, labels_pad, Npad = pad_binned(feats, thresholds, labels, N)
        vbinned = None
        if validation is not None:
            vbinned = bin_features(flatten(validation)[0], thresholds)
        data, Npad, Nvpad = make_boost_data(
            train, binned, labels_pad, N, validation, vbinned, device,
            scorer=None if self._POINTWISE else scorer)
        step = make_round_step(
            scorer, n_bins=thresholds.shape[1], n_leaves=self.n_leaves,
            min_leaf_support=self.min_leaf_support,
            learning_rate=self.learning_rate, pointwise=self._POINTWISE,
            newton=self._NEWTON, n_queries=len(train.queries),
            n_vqueries=(len(validation.queries) if validation is not None
                        else 1),
            # the per-round train metric only feeds the console table
            train_metric=not is_silent())
        state = init_state(self.n_trees, self.n_leaves, Npad, Nvpad, F,
                           device)
        return step, state, data, thresholds

    def _boost_loop(self, step, state, data, scorer, has_val: bool,
                    thresholds) -> None:
        """Round loop: console table, early stop, best-round rollback,
        ensemble export. The host reads the device only for a table line
        (not silent) or an early-stop check."""
        head = f"{'#iter':<8}| {scorer.name + '-T':<11}"
        if has_val:
            head += f"| {scorer.name + '-V':<11}"
        log(head)
        silent = is_silent()
        # silent mode reads the validation history only every `check`
        # rounds; the replayed stop rule gives the same round either way
        check = 1 if not silent else max(1, min(self.early_stop or 50, 50))
        built = 0
        stopped = False
        for t in range(self.n_trees):
            state = step(state, t, data)
            built = t + 1
            if not silent:
                line = f"{built:<8}| {float(state.train_m[t]):<11.4f}"
                if has_val:
                    line += f"| {float(state.val_m[t]):<11.4f}"
                log(line)
            if has_val and self.early_stop > 0 and built % check == 0:
                sr = _stop_round(state.val_m[:built].cpu().numpy(),
                                 self.early_stop)
                if sr is not None:
                    built, stopped = sr, True
                    log(f"Early stop at round {built} "
                        f"(no validation gain in {self.early_stop} rounds)")
                    break
        if has_val and self.early_stop > 0 and built and not stopped:
            # the last rounds may not land on the check stride
            sr = _stop_round(state.val_m[:built].cpu().numpy(),
                             self.early_stop)
            if sr is not None:
                built = sr
                log(f"Early stop at round {built} "
                    f"(no validation gain in {self.early_stop} rounds)")
        keep = built
        if has_val and built:
            # roll back to the best validation round (ref: LambdaMART
            # learn() post-loop ensemble truncation)
            keep = int(np.nanargmax(state.val_m[:built].cpu().numpy())) + 1
        self.ensemble = _export(state, keep, thresholds, self.learning_rate)
        self.fit_state = state
        # per-feature deviance reduction over all splits (ref: LambdaMART
        # impacts[], printed after training)
        self.feature_impacts = state.impacts.cpu().numpy().astype(np.float64)
        if not silent and self.feature_impacts.any():
            top = np.argsort(-self.feature_impacts)[:10]
            log("-- Feature impacts (top 10, deviance reduced)")
            for f in top:
                if self.feature_impacts[f] <= 0:
                    break
                log(f"  Feature {f + 1} : {self.feature_impacts[f]:.6g}")

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


def eval_ensemble_dataset(ensemble: TreeEnsemble, ds: Dataset,
                          device: torch.device):
    """Per-query scores of a TreeEnsemble over a dense dataset (ref
    ``eval_ensemble_dataset``, :434): flatten, pad the width to the
    model's largest fid, one ``eval_matrix`` call."""
    max_fid = 1 + max(int(t.feature.max()) for t in ensemble.trees)
    feats, _, qptr = flatten(ds)
    if feats.shape[1] < max_fid:
        feats = np.pad(feats, ((0, 0), (0, max_fid - feats.shape[1])))
    flat = ensemble.eval_matrix(feats, device)
    return [flat[qptr[i]: qptr[i + 1]] for i in range(len(ds.queries))]


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
    """The fit preamble on dense data: (feats [N, F], labels [N],
    qptr [Q+1], thresholds [F, B], N, F), the grid from real docs only."""
    feats, labels, qptr = flatten(train)
    N, F = feats.shape
    thresholds, _ = compute_thresholds(feats, n_threshold)
    return feats, labels, qptr, thresholds, N, F


def pad_binned(feats, thresholds, labels, N: int):
    """Pad the doc axis to :func:`_pad_doc_count` and bin after padding
    (pad rows bin wherever 0.0 lands; their doc weight is 0, so they are
    inert). Returns (binned [Npad, F] int32, labels_pad [Npad] f32,
    Npad)."""
    Npad = _pad_doc_count(N)
    binned = bin_features(np.pad(feats, ((0, Npad - N), (0, 0))), thresholds)
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


def _export(state, keep: int, thresholds, weight: float) -> TreeEnsemble:
    """The first ``keep`` recorded trees as a TreeEnsemble (one read of
    the records)."""
    arrs = [a[:keep].cpu().numpy() for a in (
        state.tfeat, state.tbin, state.tleft, state.tright, state.tleaf,
        state.tout, state.tnodes)]
    ens = TreeEnsemble()
    for i in range(keep):
        ens.add(_export_tree(*(a[i] for a in arrs[:6]), int(arrs[6][i]),
                             thresholds), weight)
    return ens
