"""The port's TreeEnsemble (ranklib_tpu_torch.gbdt.ensemble) against the
reference's: bit-identical packs, equal scores on every route, and the
model-file text in both directions.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import __graft_entry__ as g
from ranklib_tpu.gbdt.ensemble import TreeEnsemble as RefEnsemble
from ranklib_tpu.gbdt.ensemble import _ensemble_eval as ref_ensemble_eval
from ranklib_tpu.gbdt.ensemble import _mm_eval as ref_mm_eval
from ranklib_tpu_torch.convert import from_reference_arrays
from ranklib_tpu_torch.gbdt.ensemble import TreeEnsemble, _ensemble_eval
from ranklib_tpu_torch.ops.forest_eval import MAX_GRID, forest_eval_full_plain
from ranklib_tpu_torch.utils.errors import RankLibError

CPU = torch.device("cpu")
TOL = {"atol": 1e-5, "rtol": 1e-5}


def _case(n_trees, n_leaves, n_features, n_docs, seed):
    rng = np.random.default_rng(seed)
    ref = g._synthetic_ensemble(n_trees=n_trees, n_leaves=n_leaves,
                                n_features=n_features, rng=rng)
    X = rng.normal(size=(n_docs, n_features)).astype(np.float32)
    X[min(5, n_docs - 1), 2] = np.nan
    return ref, from_reference_arrays(ref.trees, ref.weights), X


def _wide_grid(ref, n):
    """Give feature 0 n distinct thresholds (n > 256: the f32 route)."""
    pool = np.linspace(-2.0, 2.0, n).astype(np.float32)
    i = 0
    for t in ref.trees:
        for node in np.flatnonzero(~t.is_leaf):
            t.feature[node] = 0
            t.threshold[node] = pool[i % n]
            i += 1
    return from_reference_arrays(ref.trees, ref.weights)


SHAPES = [(50, 10, 20, 300, 7), (23, 7, 13, 257, 11), (37, 7, 12, 600, 3)]


@pytest.mark.parametrize("shape", SHAPES, ids=["50x10", "odd", "37x7"])
def test_packs_bit_identical_to_reference(shape):
    ref, port, X = _case(*shape)
    F = X.shape[1]
    for want, got in [(ref._pack_matmul(F), port._pack_matmul(F)),
                      (ref._pack_matmul_bins(F), port._pack_matmul_bins(F)),
                      ((ref._model_grid_np(F),), (port._model_grid_np(F),))]:
        assert len(want) == len(got)
        for a, b in zip(want, got):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b), (a.dtype, a.shape)


def test_pack_cache_follows_add_and_truncate():
    ref, port, X = _case(30, 5, 9, 10, seed=2)
    first = port._pack_matmul_bins(9)
    port.truncate(10)
    ref.truncate(10)
    for a, b in zip(ref._pack_matmul_bins(9), port._pack_matmul_bins(9)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert port._pack_matmul_bins(9)[3].shape != first[3].shape
    assert port.forest_pack(9, CPU).split_roots.shape[0] == 10


@pytest.mark.parametrize("shape", SHAPES[1:], ids=["odd", "37x7"])
def test_eval_matrix_matches_reference_routes(shape, monkeypatch):
    """The port's eval_matrix (host-binned route, plain version on the CPU)
    against the reference's XLA route and its forced host-binned Pallas
    route, including doc chunking on both sides."""
    ref, port, X = _case(*shape)
    want_xla = ref.eval_matrix(X)                  # XLA route on CPU
    monkeypatch.setattr(RefEnsemble, "_use_bins_kernel",
                        lambda self, n_features: True)
    monkeypatch.setattr(RefEnsemble, "_EVAL_CHUNK_KERNEL", 256)
    with pltpu.force_tpu_interpret_mode():
        want_hostbin = ref.eval_matrix(X)
    monkeypatch.setattr(TreeEnsemble, "_SERVE_CHUNK_BYTES", 100 * X.shape[1])
    got = port.eval_matrix(X, CPU)
    assert got.dtype == np.float32 and got.shape == (X.shape[0],)
    np.testing.assert_allclose(got, want_xla, **TOL)
    np.testing.assert_allclose(got, want_hostbin, **TOL)


def test_device_eval_fn_matches_mm_eval():
    ref, port, X = _case(50, 10, 20, 300, seed=7)
    fn, _ = port._device_eval_fn(20, CPU)
    want = np.asarray(ref_mm_eval(jnp.asarray(X), *ref._pack_matmul(20)))
    np.testing.assert_allclose(fn(torch.from_numpy(X)).numpy(), want, **TOL)


def test_wide_grid_takes_the_f32_route_on_cpu_and_raises_elsewhere():
    ref, _, X = _case(40, 10, 6, 200, seed=4)
    port = _wide_grid(ref, MAX_GRID + 44)
    assert not port._use_bins_kernel(6)
    want = ref.eval_matrix(X)
    np.testing.assert_allclose(port.eval_matrix(X, CPU), want, **TOL)
    packed = [torch.from_numpy(a) for a in port._pack_matmul(6)]
    np.testing.assert_allclose(
        forest_eval_full_plain(torch.from_numpy(X), *packed,
                               tree_chunk=TreeEnsemble._TREE_CHUNK).numpy(),
        want, **TOL)
    # on a device that is neither the CPU nor CUDA the f32 route's wrapper
    # raises: nothing falls back
    with pytest.raises(RankLibError, match="forest_eval_full: tensors on "
                                           "meta are not supported"):
        port.eval_matrix(X, torch.device("meta"))


def test_ensemble_eval_matches_reference_traversal():
    ref, port, X = _case(23, 7, 13, 257, seed=11)
    want = np.asarray(ref_ensemble_eval(jnp.asarray(X), *ref._pack()))
    args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in port._pack()]
    got = _ensemble_eval(torch.from_numpy(X), *args).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(port.eval_matrix(X, CPU), want, **TOL)


def test_empty_inputs():
    _, port, X = _case(5, 4, 6, 10, seed=1)
    assert port.eval_matrix(X[:0], CPU).shape == (0,)
    assert TreeEnsemble().eval_matrix(X, CPU).tolist() == [0.0] * len(X)


def test_narrow_input_is_rejected_not_read_out_of_bounds():
    _, port, X = _case(20, 6, 12, 30, seed=6)
    used = max(int(t.feature[~t.is_leaf].max()) for t in port.trees)
    with pytest.raises(RankLibError, match="feature outside"):
        port.eval_matrix(X[:, :used], CPU)


def test_text_roundtrip_both_directions():
    ref, port, _ = _case(23, 7, 13, 8, seed=11)
    text = ref.to_text()
    assert port.to_text() == text
    assert TreeEnsemble.from_text(text).to_text() == text
    assert RefEnsemble.from_text(port.to_text()).to_text() == text


def test_deep_chain_tree_roundtrips():
    """A 1500-deep chain saves and loads without recursion limits."""
    depth = 1500
    M = 2 * depth + 1
    feature = np.zeros(M, np.int32)
    threshold = np.linspace(-1, 1, M).astype(np.float32)
    left = np.full(M, -1, np.int32)
    right = np.full(M, -1, np.int32)
    is_leaf = np.ones(M, bool)
    for i in range(depth):
        left[2 * i], right[2 * i], is_leaf[2 * i] = 2 * i + 1, 2 * i + 2, False
    from ranklib_tpu_torch.gbdt.ensemble import Tree
    ens = TreeEnsemble()
    ens.add(Tree(feature, threshold, left, right, is_leaf,
                 np.arange(M, dtype=np.float32)), 0.5)
    text = ens.to_text()
    assert TreeEnsemble.from_text(text).to_text() == text


_SPLIT = ("<ensemble>\n\t<tree id=\"1\" weight=\"0.1\">\n\t\t<split>\n"
          "\t\t\t<feature> 1 </feature>\n{thr}"
          "\t\t\t<split pos=\"left\">\n\t\t\t\t<output> 1.000000000000000 </output>\n"
          "\t\t\t</split>\n\t\t\t<split pos=\"right\">\n"
          "\t\t\t\t{out}\n\t\t\t</split>\n\t\t</split>\n\t</tree>\n"
          "</ensemble>\n")


@pytest.mark.parametrize("thr,out", [
    ("", "<output> 2.000000000000000 </output>"),                       # no <threshold>
    ("\t\t\t<threshold></threshold>\n", "<output> 2.000000000000000 </output>"),
    ("\t\t\t<threshold> x </threshold>\n", "<output> 2.000000000000000 </output>"),
    ("\t\t\t<threshold> 0.5 </threshold>\n", "<output></output>"),
], ids=["missing-threshold", "empty-threshold", "bad-threshold",
        "empty-output"])
def test_malformed_split_raises_ranklib_error(thr, out):
    good = _SPLIT.format(thr="\t\t\t<threshold> 0.5 </threshold>\n",
                         out="<output> 2.000000000000000 </output>")
    assert TreeEnsemble.from_text(good).to_text() == good
    with pytest.raises(RankLibError):
        TreeEnsemble.from_text(_SPLIT.format(thr=thr, out=out))


def test_convert_copies_the_reference_arrays():
    ref, port, _ = _case(3, 4, 5, 1, seed=0)
    before = copy.deepcopy(port.trees[0].threshold)
    ref.trees[0].threshold[:] = 7.0
    np.testing.assert_array_equal(port.trees[0].threshold, before)
    with pytest.raises(ValueError):
        from_reference_arrays(ref.trees, ref.weights[:-1])


def test_chip_smoke_generator_draws_like_the_benchmark_fixture():
    """chip_smoke.py cannot import __graft_entry__ (it reaches JAX), so it
    carries its own copy of the synthetic-ensemble generator; both must
    draw the same trees from the same seed."""
    import chip_smoke

    want = g._synthetic_ensemble(n_trees=12, n_leaves=10, n_features=136,
                                 rng=np.random.default_rng(0))
    got = chip_smoke.synthetic_ensemble(12, 10, 136, np.random.default_rng(0))
    assert got.weights == want.weights
    for a, b in zip(got.trees, want.trees, strict=True):
        for f in ("feature", "threshold", "left", "right", "is_leaf",
                  "output"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
