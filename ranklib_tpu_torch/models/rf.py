"""Random Forests ranker (`-ranker 8`) (ranklib_tpu.models.rf; ref:
learning/tree/RFRanker.java:~25).

``nBag`` (300) bagged MART (``-rtype 0``) or LambdaMART (``-rtype 6``)
ensembles. Per bag: queries sampled with replacement at
``subSamplingRate`` (1.0), features without replacement at
``featureSamplingRate`` (0.3), both from one numpy generator seeded with
``seed`` in the reference's order, so every bag is the reference's; the
bag trains with bag-local ``-tree`` (1), ``-leaf`` (100) and shrinkage
(0.1). A bag is a weight vector over the one binned dataset: a query
drawn k times weighs its docs k (exactly the doc duplicated k times in
every histogram, count and leaf sum), and the feature sample is a mask.
Score = MEAN of the bag ensembles' scores; the model file concatenates
the bags' ``<ensemble>`` blocks under one ``## Random Forests`` header.

* ``-rtype 0``: groups of bags grow their trees in lockstep
  (:func:`group_step` → ``gbdt.grow.grow_forest``), one multi-bag
  histogram launch per split for the whole group; all bag draws happen
  upfront in bag order, so the model does not depend on the grouping.
* ``-rtype 6``: one LambdaMART fit per bag through the boosting round
  (``gbdt.boost``) with the bag's weights and feature mask; lambdas use
  every query, as in the reference.

On a streamed ``-sparse`` dataset (``data.binned.BinnedDataset``) the bags
weigh rows of its bin matrix the same way, and a bag's console train
metric scores its rows in bin space.

* ``-dp`` (a ``parallel.dist.Mesh`` of more than one rank): as the
  reference's ``_fit_bags_rebuild``, each bag is a data-parallel MART
  (``-rtype 0``) or LambdaMART (``-rtype 6``) fit on its sampled queries
  (a query drawn k times is k queries), the whole forest in one process
  group: every rank draws the same bags from the same generator and takes
  its share of each bag's queries from the full bin matrix, which it maps
  from shared memory.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ranklib_tpu_torch.data.dataset import Dataset, flatten, flatten_meta
from ranklib_tpu_torch.data.sampling import sample_features, sample_queries
from ranklib_tpu_torch.device import choose_device
from ranklib_tpu_torch.gbdt.boost import (
    init_state, make_boost_data, make_round_step, upload_bins,
)
from ranklib_tpu_torch.gbdt.binning import bin_features
from ranklib_tpu_torch.gbdt.ensemble import TreeEnsemble
from ranklib_tpu_torch.gbdt.grow import grow_forest, leaf_outputs_forest
from ranklib_tpu_torch.metrics.base import score_dataset
from ranklib_tpu_torch.models.base import (
    Ranker, model_header, parse_model_params, register_ranker,
)
from ranklib_tpu_torch.models.gbdt import (
    MART, LambdaMART, _eval_binned, _export, _export_tree,
    check_same_models, eval_ensemble_dataset, flatten_binned, labels_only,
    launch_counts, launches_since, pad_binned, shared,
)
from ranklib_tpu_torch.utils.errors import RankLibError
from ranklib_tpu_torch.utils.logging import is_silent, log, set_silent

# device memory a group of bags may take: a quarter of the card's, or this
# much on the CPU
_CPU_GROUP_BYTES = 2 << 30


def _bag_train_metric(ens: TreeEnsemble, sampled: Dataset, qidx, qptr,
                      binned, thresholds, scorer,
                      device: torch.device) -> float:
    """A bag's train metric on its own sample, for the console table (ref
    ``_bag_train_metric``, rf.py:34). Dense bags score their features; a
    streamed bag has none, so the ensemble is rebased to bin space and
    scores the sampled rows of the shared bin matrix (``binned``; exact,
    its thresholds are grid points)."""
    if binned is not None:
        rows = (np.concatenate([np.arange(qptr[i], qptr[i + 1])
                                for i in qidx])
                if len(qidx) else np.zeros(0, np.int64))
        flat = _eval_binned(ens.to_bin_space(thresholds), binned[rows],
                            device)
    else:
        flat = ens.eval_matrix(flatten(sampled)[0], device)
    sqptr = np.zeros(len(sampled.queries) + 1, np.int64)
    np.cumsum([q.n for q in sampled.queries], out=sqptr[1:])
    scores = [flat[sqptr[i]: sqptr[i + 1]]
              for i in range(len(sampled.queries))]
    return score_dataset(scorer, sampled, scores, device)[0]


def group_step(scores: torch.Tensor, doc_w: torch.Tensor,
               fmask: torch.Tensor, binned_T: torch.Tensor,
               labels: torch.Tensor, n_bins: int, n_leaves: int, lr: float):
    """One lockstep MART round for a group of bags (ref
    ``_rf_group_step``, rf.py:63): residuals → forest → mean-residual leaf
    outputs → score update. ``scores``/``doc_w`` [Cb, Npad], ``fmask``
    [Cb, F] bool. Returns (scores, (feature, bin, left, right, is_leaf,
    n_nodes, out)) as device tensors; nothing is read back."""
    M = 2 * n_leaves - 1
    lam = labels[None, :] - scores                      # MART residuals
    arr = grow_forest(binned_T, lam, n_bins, n_leaves, 1, doc_w, fmask)
    out = leaf_outputs_forest(arr.node_of_doc, lam, torch.ones_like(lam), M,
                              False, doc_w)
    scores = scores + lr * out.gather(1, arr.node_of_doc.long())
    return scores, (arr.feature, arr.bin, arr.left, arr.right, arr.is_leaf,
                    arr.n_nodes, out)


def bag_group_size(M: int, F: int, B: int, N: int, n_bags: int,
                   device: torch.device) -> int:
    """Bags grown in lockstep per group: as many as fit a quarter of the
    card's memory (``_CPU_GROUP_BYTES`` on the CPU) — per bag the
    [M, F, B, 2] f32 node-histogram buffer, its stacked children and
    scan, and ~16 [N]-sized temporaries; at most ``n_bags``. The model does
    not depend on it."""
    per_bag = (M + 3) * F * B * 8 + 16 * N * 4
    budget = (torch.cuda.get_device_properties(device).total_memory // 4
              if device.type == "cuda" else _CPU_GROUP_BYTES)
    return max(1, min(n_bags, budget // per_bag))


@register_ranker
class RFRanker(Ranker):
    NAME = "Random Forests"

    def __init__(self, **hp):
        self.n_bags = 300
        self.sub_sampling_rate = 1.0
        self.feature_sampling_rate = 0.3
        self.ranker_type = 0            # 0 = MART, 6 = LambdaMART
        self.n_trees = 1
        self.n_leaves = 100
        self.learning_rate = 0.1
        self.n_threshold = 256
        self.seed = 0
        self.ensembles: list[TreeEnsemble] = []
        self._merged = None
        self.rank_launches = None       # the last -dp fit's, a dict a rank
        super().__init__(**hp)
        if self.ranker_type not in (0, 6):
            raise RankLibError(
                "Random Forests supports -rtype 0 (MART) or 6 (LambdaMART)")

    def _draw_bag(self, train: Dataset, F: int, rng, feature_mask=None):
        """(sampled Dataset, its query indices, [Q] f32 multiplicities,
        [F] bool feature mask): one bag's draws, in the reference's order;
        the feature sample is intersected with ``feature_mask``."""
        sampled, _, qidx = sample_queries(train, self.sub_sampling_rate, rng)
        fids = sample_features(F, self.feature_sampling_rate, rng)
        fmask = np.zeros(F, bool)
        fmask[[f - 1 for f in fids]] = True
        if feature_mask is not None:
            fmask &= feature_mask
        mult = np.bincount(qidx, minlength=len(train.queries))
        return sampled, qidx, mult.astype(np.float32), fmask

    def fit(self, train: Dataset, scorer, validation: Dataset | None = None,
            device: torch.device | None = None,
            feature_mask: np.ndarray | None = None, mesh=None,
            profile_dir: str | None = None) -> None:
        """Train on ``device`` (default: :func:`choose_device`'s, as the
        CLI picks it). ``validation`` is ignored, as in the reference.
        ``feature_mask``: optional [F] bool (``-feature`` on the streamed
        ``-sparse`` path), intersected with every bag's feature sample.
        ``mesh``: of more than one rank, :meth:`_fit_bags_rebuild`, whose
        ranks write their profiler traces into ``profile_dir``."""
        device = choose_device(quiet=True) if device is None else device
        if mesh is not None and mesh.size > 1:
            return self._fit_bags_rebuild(train, scorer, mesh, feature_mask,
                                          profile_dir)
        if self.ranker_type == 0:
            return self._fit_bags_batched(train, scorer, device,
                                          feature_mask)
        rng = np.random.default_rng(self.seed)
        log("Training starts...")
        feats, labels, qptr, thresholds, binned_real, N, F = flatten_binned(
            train, self.n_threshold)
        doc_counts = np.diff(qptr)
        B = thresholds.shape[1]
        binned, labels_pad, Npad = pad_binned(feats, binned_real, thresholds,
                                              labels, N)
        data, Npad, _ = make_boost_data(train, binned, labels_pad, N, None,
                                        None, device, scorer=scorer)
        step = make_round_step(
            scorer, n_bins=B, n_leaves=self.n_leaves, min_leaf_support=1,
            learning_rate=self.learning_rate, pointwise=False, newton=True,
            n_queries=len(train.queries), n_vqueries=1, train_metric=False)
        self.ensembles = []
        silent = is_silent()
        for bag in range(self.n_bags):
            sampled, qidx, mult, fmask = self._draw_bag(train, F, rng,
                                                        feature_mask)
            doc_w = np.zeros(Npad, np.float32)
            doc_w[:N] = np.repeat(mult, doc_counts)
            bag_data = dataclasses.replace(
                data, doc_mask=torch.from_numpy(doc_w).to(device),
                feat_mask=torch.from_numpy(fmask).to(device))
            state = init_state(self.n_trees, self.n_leaves, Npad, 0, F,
                               device)
            for t in range(self.n_trees):
                state = step(state, t, bag_data)
            ens = _export(state, self.n_trees, thresholds, self.learning_rate)
            self.ensembles.append(ens)
            if not silent:
                m = _bag_train_metric(ens, sampled, qidx, qptr, binned_real,
                                      thresholds, scorer, device)
                log(f"bag {bag + 1:<5}| {scorer.name}-bag: {m:.4f}")
        self._merged = None

    def _fit_bags_batched(self, train: Dataset, scorer,
                          device: torch.device, feature_mask=None) -> None:
        """``-rtype 0`` (the default): groups of bags grow their trees in
        lockstep (:func:`group_step`). Bag draws happen upfront in bag
        order, so every bag is the per-bag path's; the host reads the
        trees once per group."""
        rng = np.random.default_rng(self.seed)
        log("Training starts...")
        feats, labels, qptr, thresholds, binned_real, N, F = flatten_binned(
            train, self.n_threshold)
        Q = len(train.queries)
        B = thresholds.shape[1]
        binned, labels_pad, Npad = pad_binned(feats, binned_real, thresholds,
                                              labels, N)
        binned_T = upload_bins(np.ascontiguousarray(binned.T), device)
        labels_dev = torch.from_numpy(labels_pad).to(device)
        bags = [self._draw_bag(train, F, rng, feature_mask)
                for _ in range(self.n_bags)]
        # doc → query, with a zero-weight sentinel query Q for pad docs
        qod = np.full(Npad, Q, np.int64)
        qod[:N] = np.repeat(np.arange(Q), np.diff(qptr))
        query_of_doc = torch.from_numpy(qod).to(device)

        M = 2 * self.n_leaves - 1
        Cb = bag_group_size(M, F, B, Npad, self.n_bags, device)
        lr = self.learning_rate
        self.ensembles = []
        silent = is_silent()
        for lo in range(0, self.n_bags, Cb):
            group = bags[lo:lo + Cb]
            mult = np.zeros((len(group), Q + 1), np.float32)   # col Q: pads
            mult[:, :Q] = [m for _, _, m, _ in group]
            doc_w = torch.from_numpy(mult).to(device)[:, query_of_doc]
            fmask = torch.from_numpy(np.stack([f for *_, f in group])).to(
                device)
            scores = torch.zeros((len(group), Npad), dtype=torch.float32,
                                 device=device)
            rounds = []
            for _ in range(self.n_trees):
                scores, tree = group_step(scores, doc_w, fmask, binned_T,
                                          labels_dev, B, self.n_leaves, lr)
                rounds.append(tree)
            rounds = [[a.cpu().numpy() for a in tree] for tree in rounds]
            for c, (sampled, qidx, *_) in enumerate(group):
                ens = TreeEnsemble()
                for tf, tb, tl, tr, tlf, tn, out in rounds:
                    ens.add(_export_tree(tf[c], tb[c], tl[c], tr[c], tlf[c],
                                         out[c], int(tn[c]), thresholds), lr)
                self.ensembles.append(ens)
                if not silent:
                    m = _bag_train_metric(ens, sampled, qidx, qptr,
                                          binned_real, thresholds, scorer,
                                          device)
                    log(f"bag {lo + c + 1:<5}| {scorer.name}-bag: {m:.4f}")
        self._merged = None

    def _fit_bags_rebuild(self, train: Dataset, scorer, mesh,
                          feature_mask=None, profile_dir=None) -> None:
        """``-dp`` (ref ``_fit_bags_rebuild``, rf.py:310-355): one grid and
        bin matrix for every bag, here, in shared memory; the ranks
        (:func:`_bags_rank`) fit the bags one after another.
        ``rank_launches`` keeps each rank's kernel launches."""
        from ranklib_tpu_torch.parallel.dist import run

        log("Training starts...")
        feats, _, _, thresholds, binned, _, _ = flatten_binned(
            train, self.n_threshold)
        if binned is None:
            binned = bin_features(feats, thresholds)
        out = run(mesh, _bags_rank, self, labels_only(train),
                  shared(binned, mesh),
                  thresholds, feature_mask, scorer, profile_dir=profile_dir)
        for bag in range(self.n_bags):
            check_same_models([ens[bag] for ens, _ in out])
        self.ensembles = out[0][0]
        self.rank_launches = [c for _, c in out]
        self._merged = None

    # ---- scoring ---------------------------------------------------------
    def _merged_ensemble(self) -> TreeEnsemble:
        """All bags in one ensemble, tree weights scaled by 1/nBags (score
        = mean over bags, ref: RFRanker.eval)."""
        if self._merged is None:
            if not self.ensembles:
                raise RankLibError("Model not trained/loaded")
            merged = TreeEnsemble()
            inv = 1.0 / len(self.ensembles)
            for ens in self.ensembles:
                for tree, w in zip(ens.trees, ens.weights):
                    merged.add(tree, w * inv)
            self._merged = merged
        return self._merged

    def eval_dataset(self, ds: Dataset, device: torch.device):
        return eval_ensemble_dataset(self._merged_ensemble(), ds, device)

    # ---- serialization -----------------------------------------------------
    def model_str(self) -> str:
        head = model_header(self.NAME, {
            "No. of bags": len(self.ensembles),
            "Sub-sampling": self.sub_sampling_rate,
            "Feature-sampling": self.feature_sampling_rate,
            "No. of trees": self.n_trees,
            "No. of leaves": self.n_leaves,
            "Learning rate": self.learning_rate,
        })
        return head + "\n" + "\n".join(e.to_text() for e in self.ensembles)

    def load_str(self, text: str) -> None:
        params, _ = parse_model_params(text)
        if "No. of bags" in params:
            self.n_bags = int(params["No. of bags"])
        self.ensembles = parse_ensembles(text)
        if not self.ensembles:
            raise RankLibError("No <ensemble> blocks in Random Forests model")
        self._merged = None


def _bags_rank(rank, device, group, rf: RFRanker, train: Dataset, binned,
               thresholds, feature_mask, scorer) -> list:
    """A ``-dp`` rank of :meth:`RFRanker._fit_bags_rebuild`: every bag's
    draws, in the reference's order, then the bag's data-parallel fit on
    this rank's share of its queries (their rows of the full ``binned``);
    rank 0 logs each bag's train metric. Returns (the bags' ensembles,
    the rank's :func:`launch_counts` over the fit)."""
    before = launch_counts()
    binned = binned.numpy()
    F = binned.shape[1]
    qptr = flatten_meta(train)[1]
    rng = np.random.default_rng(rf.seed)
    cls = MART if rf.ranker_type == 0 else LambdaMART
    silent = is_silent()
    ensembles = []
    for bag in range(rf.n_bags):
        sampled, qidx, _, fmask = rf._draw_bag(train, F, rng, feature_mask)
        ranker = cls(n_trees=rf.n_trees, n_leaves=rf.n_leaves,
                     learning_rate=rf.learning_rate, early_stop=0,
                     n_threshold=rf.n_threshold)
        set_silent(True)              # per-bag round tables are noise
        try:
            ranker.fit_shard(rank, device, group, sampled, binned,
                             thresholds, scorer, feature_mask=fmask,
                             qstart=qptr[qidx])
        finally:
            set_silent(silent)
        ensembles.append(ranker.ensemble)
        if rank == 0 and not silent:
            m = _bag_train_metric(ranker.ensemble, sampled, qidx, qptr,
                                  binned, thresholds, scorer, device)
            log(f"bag {bag + 1:<5}| {scorer.name}-bag: {m:.4f}")
    return ensembles, launches_since(before)


def parse_ensembles(text: str) -> list[TreeEnsemble]:
    """All <ensemble> blocks in a model text, in order."""
    out = []
    pos = 0
    while True:
        start = text.find("<ensemble>", pos)
        if start < 0:
            break
        end = text.find("</ensemble>", start)
        if end < 0:
            raise RankLibError("Unterminated <ensemble> block")
        end += len("</ensemble>")
        out.append(TreeEnsemble.from_text(text[start:end]))
        pos = end
    return out
