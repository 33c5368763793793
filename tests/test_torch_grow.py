"""The port's tree growth and training binning (ranklib_tpu_torch.gbdt.grow,
.binning) against the reference's and the float64 oracle's.

Same numpy-seeded bins and gradients through both packages: the grown
arrays (feature, bin, children, leaves, slots in use, every doc's leaf)
must be equal; impacts and leaf outputs agree to rtol 1e-5 (f32 sums in
another order). The oracle (``tools/oracle.py``), which shares no code
with either package, must grow the same structure.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ranklib_tpu.gbdt import binning as RB
from ranklib_tpu.gbdt.grow import grow_tree as ref_grow
from ranklib_tpu.gbdt.grow import leaf_outputs as ref_leaf_outputs
from ranklib_tpu_torch.gbdt import binning as PB
from ranklib_tpu_torch.gbdt.grow import grow_tree, leaf_outputs
from ranklib_tpu_torch.native import loader
from tools import oracle as orc

FIELDS = ("feature", "bin", "left", "right", "is_leaf", "n_nodes",
          "node_of_doc")


def _inputs(N, F, seed, tc=16, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(N, F)).astype(np.float32)
    feats[:, min(2, F - 1)] = rng.integers(0, 4, N)     # few uniques
    grad = rng.normal(size=N).astype(np.float32)
    thr, _ = PB.compute_thresholds(feats, tc)
    binned = PB.bin_features(feats, thr)
    return feats, thr, np.ascontiguousarray(binned.T.astype(dtype)), grad


def _both(binned_T, grad, B, L, mls=1, doc_mask=None, fmask=None):
    want = ref_grow(jnp.asarray(binned_T), jnp.asarray(grad), n_bins=B,
                    n_leaves=L, min_leaf_support=mls,
                    doc_mask=None if doc_mask is None
                    else jnp.asarray(doc_mask),
                    feature_mask=None if fmask is None
                    else jnp.asarray(fmask))
    got = grow_tree(torch.from_numpy(binned_T), torch.from_numpy(grad),
                    n_bins=B, n_leaves=L, min_leaf_support=mls,
                    doc_mask=None if doc_mask is None
                    else torch.from_numpy(doc_mask),
                    feature_mask=None if fmask is None
                    else torch.from_numpy(fmask))
    return want, got


@pytest.mark.parametrize("weights", ["none", "bool", "f32"])
@pytest.mark.parametrize("L", [2, 4, 7])
def test_grow_tree_matches_reference(weights, L):
    _, thr, binned_T, grad = _inputs(400, 6, seed=L)
    rng = np.random.default_rng(L + 1)
    dm = {"none": None, "bool": rng.random(400) > 0.2,
          "f32": rng.integers(0, 3, 400).astype(np.float32)}[weights]
    want, got = _both(binned_T, grad, thr.shape[1], L, doc_mask=dm)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(got.impacts.numpy(), np.asarray(want.impacts),
                               rtol=1e-5, atol=1e-6)
    lam = grad
    w = np.abs(grad) + 0.5
    for newton in (True, False):
        ref_out = ref_leaf_outputs(
            want.node_of_doc, jnp.asarray(lam), jnp.asarray(w), 2 * L - 1,
            newton, doc_mask=None if dm is None else jnp.asarray(dm))
        out = leaf_outputs(got.node_of_doc, torch.from_numpy(lam),
                           torch.from_numpy(w), 2 * L - 1, newton,
                           doc_mask=None if dm is None
                           else torch.from_numpy(dm))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32])
def test_bin_types_and_feature_mask(dtype):
    """uint8/int16/int32 ids grow the same tree; masked-out features are
    never split on, as in the reference; mls 3 and -mls 0."""
    _, thr, binned_T, grad = _inputs(300, 5, seed=3, dtype=dtype)
    fmask = np.array([True, False, True, True, False])
    for mls in (0, 3):
        want, got = _both(binned_T, grad, thr.shape[1], 6, mls=mls,
                          fmask=fmask)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
        used = got.feature.numpy()[~got.is_leaf.numpy()
                                   & (got.feature.numpy() >= 0)]
        assert fmask[used].all()


def test_growth_stops_when_nothing_splits():
    """mls above half the docs: only the root can split once at most;
    unused slots keep is_leaf False and children −1."""
    _, thr, binned_T, grad = _inputs(50, 3, seed=4)
    want, got = _both(binned_T, grad, thr.shape[1], 5, mls=30)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert int(got.n_nodes) == 1 and got.is_leaf.numpy()[0]


def test_structure_matches_oracle():
    feats, thr, binned_T, grad = _inputs(300, 5, seed=11)
    arr = grow_tree(torch.from_numpy(binned_T), torch.from_numpy(grad),
                    n_bins=thr.shape[1], n_leaves=6, min_leaf_support=3)
    thr_o = orc.compute_thresholds_oracle(feats, 16)
    cols = [orc.bin_column(feats[:, f], thr_o[f]) for f in range(5)]
    tree_o, node_of_doc_o, imp_o = orc.grow_tree_oracle(
        cols, grad.astype(np.float64), 6, 3.0, thr_o)
    n_nodes = int(arr.n_nodes)
    assert n_nodes == len(tree_o.nodes)
    for s in range(n_nodes):
        nd = tree_o.nodes[s]
        assert bool(arr.is_leaf[s]) == nd.is_leaf
        if not nd.is_leaf:
            assert (int(arr.feature[s]), int(arr.bin[s])) == (nd.feature,
                                                              nd.bin)
            assert (int(arr.left[s]), int(arr.right[s])) == (nd.left,
                                                             nd.right)
    np.testing.assert_array_equal(arr.node_of_doc.numpy(), node_of_doc_o)
    np.testing.assert_allclose(arr.impacts.numpy(), imp_o, rtol=1e-4)


@pytest.mark.parametrize("tc", [4, 16, 256, 300])
def test_thresholds_and_bins_match_reference(tc):
    """Grids (B = 8 or a multiple of 128) and bins, NaN → B; the native
    binner and the numpy fallback agree."""
    rng = np.random.default_rng(tc)
    feats = rng.normal(size=(500, 4)).astype(np.float32)
    feats[:, 1] = rng.integers(0, 5, 500)
    feats[::7, 3] = np.nan
    thr, nb = PB.compute_thresholds(feats, tc)
    rthr, rnb = RB.compute_thresholds(feats, tc)
    np.testing.assert_array_equal(thr, rthr)
    np.testing.assert_array_equal(nb, rnb)
    assert thr.shape[1] == 8 or thr.shape[1] % 128 == 0
    bins = PB.bin_features(feats, thr)
    np.testing.assert_array_equal(bins, RB.bin_features(feats, thr))
    assert bins.dtype == np.int32 and (bins[::7, 3] == thr.shape[1]).all()


def test_numpy_fallbacks_match_native(monkeypatch):
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(300, 3)).astype(np.float32)
    feats[:, 0] = rng.integers(0, 6, 300)
    thr, nb = PB.compute_thresholds(feats, 32)
    bins = PB.bin_features(feats, thr)
    monkeypatch.setattr(loader, "native_feature_uniques", lambda *a: None)
    monkeypatch.setattr(loader, "native_bin_features", lambda *a: None)
    thr2, nb2 = PB.compute_thresholds(feats, 32)
    np.testing.assert_array_equal(thr2, thr)
    np.testing.assert_array_equal(nb2, nb)
    np.testing.assert_array_equal(PB.bin_features(feats, thr), bins)
