"""Carry a reference ensemble or training state into the port.

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
