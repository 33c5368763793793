"""Carry a reference ensemble's weights into the port.

Duck-typed: it reads each tree's numpy fields and imports nothing from
``ranklib_tpu``, so tests can feed one ensemble to both packages.
"""

from __future__ import annotations

import numpy as np

from ranklib_tpu_torch.gbdt.ensemble import Tree, TreeEnsemble


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
