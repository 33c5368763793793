"""Carry a reference ensemble, Random Forest, linear, boosting or neural
ranker, or training state into the port.

Duck-typed: it reads numpy-convertible fields and imports nothing from
``ranklib_tpu``, so tests can feed one model or one mid-training state to
both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ranklib_tpu_torch.gbdt.boost import BoostState
from ranklib_tpu_torch.gbdt.ensemble import Tree, TreeEnsemble
from ranklib_tpu_torch.gbdt.grow import TreeArrays


def from_reference_arrays(trees, weights) -> TreeEnsemble:
    """``trees``: objects with ``feature, threshold, left, right, is_leaf,
    output`` arrays (``ranklib_tpu.gbdt.ensemble.Tree``'s fields);
    ``weights``: one float per tree. Returns the port's TreeEnsemble over
    copies of those arrays."""
    trees, weights = list(trees), list(weights)
    if len(trees) != len(weights):
        raise ValueError(f"{len(trees)} trees but {len(weights)} weights")
    ens = TreeEnsemble()
    for t, w in zip(trees, weights):
        ens.add(Tree(*(np.array(getattr(t, f)) for f in Tree.__slots__)), w)
    return ens


def rf_from_reference(ref_rf):
    """A reference ``RFRanker`` (its ``ensembles`` and hyperparameters) →
    the port's ``RFRanker`` over copies of its bags' arrays."""
    from ranklib_tpu_torch.models.rf import RFRanker

    hp = {k: getattr(ref_rf, k) for k in (
        "n_bags", "sub_sampling_rate", "feature_sampling_rate",
        "ranker_type", "n_trees", "n_leaves", "learning_rate", "n_threshold",
        "seed")}
    rf = RFRanker(**hp)
    rf.ensembles = [from_reference_arrays(e.trees, e.weights)
                    for e in ref_rf.ensembles]
    return rf


def boost_state_from_reference(ref, device: torch.device):
    """A reference ``BoostState`` or ``TreeArrays`` (any object with those
    fields, e.g. after ``jax.device_get``) → the port's, as copies on
    ``device`` with the same dtypes. Lets a test start both packages'
    round from one mid-training state."""
    if hasattr(ref, "scores"):
        cls = BoostState
        names = [f.name for f in dataclasses.fields(BoostState)]
    else:
        cls = TreeArrays
        names = list(TreeArrays._fields)
    return cls(**{n: torch.from_numpy(np.array(getattr(ref, n))).to(device)
                  for n in names})


def _copy_hparams(ref, port_cls, names):
    return port_cls(**{k: getattr(ref, k) for k in names})


def coorascent_from_reference(ref):
    """A reference ``CoorAscent`` → the port's, with its hyperparameters
    and a copy of its f64 ``weights``."""
    from ranklib_tpu_torch.models.coorascent import CoorAscent

    out = _copy_hparams(ref, CoorAscent, (
        "n_restart", "n_max_iteration", "tolerance", "reg", "max_passes",
        "seed"))
    out.weights = np.array(ref.weights, np.float64)
    return out


def linear_from_reference(ref):
    """A reference ``LinearRegRank`` → the port's: ``lam`` and a copy of
    the f64 ``weights`` (intercept first)."""
    from ranklib_tpu_torch.models.linear import LinearRegRank

    out = _copy_hparams(ref, LinearRegRank, ("lam",))
    out.weights = np.array(ref.weights, np.float64)
    return out


def adarank_from_reference(ref):
    """A reference ``AdaRank`` → the port's: its hyperparameters, its
    ``history`` of (fid, α) rounds and the weights they sum to."""
    from ranklib_tpu_torch.models.adarank import AdaRank

    out = _copy_hparams(ref, AdaRank, (
        "n_rounds", "tolerance", "no_eq", "max_sel_count"))
    out.history = [(int(f), float(a)) for f, a in ref.history]
    out.weights = np.array(ref.weights, np.float64)
    return out


def rankboost_from_reference(ref):
    """A reference ``RankBoost`` → the port's: its hyperparameters and its
    weak rankers, (fid, threshold value, α) each — all that scoring
    reads."""
    from ranklib_tpu_torch.models.rankboost import RankBoost

    out = _copy_hparams(ref, RankBoost, ("n_rounds", "n_threshold"))
    out.weaks = [(int(f), float(th), float(a)) for f, th, a in ref.weaks]
    return out


def neural_from_reference(ref):
    """A reference ``RankNet``, ``LambdaRank`` or ``ListNet`` → the port's
    class of the same name: its hyperparameters and f32 copies of its
    ``(W, b)`` layers."""
    from ranklib_tpu_torch.models.base import get_ranker_class

    out = _copy_hparams(ref, get_ranker_class(ref.NAME), (
        "n_epoch", "n_layers", "n_hidden_per_layer", "learning_rate",
        "seed"))
    out.params = [(np.array(W, np.float32), np.array(b, np.float32))
                  for W, b in ref.params]
    out.n_features = ref.n_features
    return out
