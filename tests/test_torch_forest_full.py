"""The port's f32 forest route (ranklib_tpu_torch.ops.forest_eval
``forest_eval_full``, routed by ``TreeEnsemble.serving_route``) against the
reference's ``forest_eval_pallas_full`` in TPU interpret mode, its
``_mm_eval`` and both packages' pointer traversal ``_ensemble_eval``.

The route serves models with more than 256 thresholds on a feature and
inputs wider than ``MAX_FEATURES``. It compares ``x <= t`` in f32, so
every document must reach the traversal's leaf — NaN (right), ±inf, and
thresholds beyond the reference kernel's ±3e38 clamp included. Scores
agree to 1e-5 (the reference kernels' tolerance); leaf identities and the
emulated CUDA walk are held exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import __graft_entry__ as g
from ranklib_tpu.gbdt.ensemble import TreeEnsemble as RefEnsemble
from ranklib_tpu.gbdt.ensemble import _ensemble_eval as ref_ensemble_eval
from ranklib_tpu.gbdt.ensemble import _mm_eval as ref_mm_eval
from ranklib_tpu.ops.forest_eval import forest_eval_pallas_full
from ranklib_tpu_torch.convert import from_reference_arrays
from ranklib_tpu_torch.gbdt.ensemble import Tree, TreeEnsemble, _ensemble_eval
from ranklib_tpu_torch.ops import forest_eval as fe
from ranklib_tpu_torch.utils.errors import RankLibError

CPU = torch.device("cpu")
TOL = {"atol": 1e-5, "rtol": 1e-5}
FMAX = float(np.finfo(np.float32).max)
EXTREME = np.array([FMAX, 3.2e38, 3.0e38, -3.1e38, -FMAX],
                   np.float32)


def _case(n_trees, n_leaves, n_features, n_docs, seed, wide_grid=0):
    """A reference synthetic ensemble (feature 0 gets ``wide_grid``
    distinct thresholds when set), its port copy, and N(0,1) docs with
    values ON thresholds, NaN and ±inf."""
    rng = np.random.default_rng(seed)
    ref = g._synthetic_ensemble(n_trees=n_trees, n_leaves=n_leaves,
                                n_features=n_features, rng=rng)
    if wide_grid:
        pool = np.linspace(-2.0, 2.0, wide_grid).astype(np.float32)
        i = 0
        for t in ref.trees:
            for node in np.flatnonzero(~t.is_leaf)[::2]:
                t.feature[node] = 0
                t.threshold[node] = pool[i % wide_grid]
                i += 1
    X = rng.normal(size=(n_docs, n_features)).astype(np.float32)
    thrs = np.concatenate([t.threshold[~t.is_leaf] for t in ref.trees])
    flat = X.reshape(-1)
    pick = rng.integers(0, len(thrs), size=len(flat) // 3)
    flat[: len(pick)] = thrs[pick]
    X[::13, 1 % n_features] = np.nan
    X[3, 0] = -np.inf
    X[4, 0] = np.inf
    X[5, 2 % n_features] = np.inf
    return ref, from_reference_arrays(ref.trees, ref.weights), X


def _t(a):
    return torch.from_numpy(np.array(a))          # writable copy


def _traversal(ens, X):
    args = [_t(a) if isinstance(a, np.ndarray) else a for a in ens._pack()]
    return _ensemble_eval(_t(X), *args).numpy()


@pytest.mark.parametrize("shape", [(50, 10, 20, 300, 7, 0),
                                   (110, 7, 13, 257, 11, 300)],
                         ids=["50x10", "odd-300-thresholds"])
def test_f32_plain_matches_reference_kernel_and_scan(shape):
    ref, port, X = _case(*shape)
    F = X.shape[1]
    assert (port._bins_grid_meta()[1] > 256) == bool(shape[-1])
    packed = ref._pack_matmul(F)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(forest_eval_pallas_full(jnp.asarray(X), *packed))
    got = fe.forest_eval_full(_t(X), port.full_pack(F, CPU)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, np.asarray(ref_mm_eval(jnp.asarray(X),
                                                           *packed)), **TOL)
    np.testing.assert_allclose(got, _traversal(port, X), **TOL)


def _leaf_id_trees(ref, extreme: bool):
    """One single-tree ensemble per tree of ``ref`` with every leaf's
    output its slot id (weight 1), so a score names the leaf exactly;
    with ``extreme``, every third split threshold comes from EXTREME."""
    out = []
    for i, t in enumerate(ref.trees):
        t = type(t)(t.feature.copy(), t.threshold.copy(), t.left, t.right,
                    t.is_leaf, np.arange(len(t.feature), dtype=np.float32))
        if extreme:
            for j, node in enumerate(np.flatnonzero(~t.is_leaf)[::3]):
                t.threshold[node] = EXTREME[(i + j) % len(EXTREME)]
        one = RefEnsemble()
        one.add(t, 1.0)
        out.append(one)
    return out


@pytest.mark.parametrize("extreme", [False, True],
                         ids=["in-band", "thresholds-past-3e38"])
def test_every_doc_reaches_the_traversal_leaf(extreme):
    """Leaf for leaf against the reference's and the port's traversal,
    and (in band only: its ±3e38 clamp is exact there, the reason for the
    reference's band gate) its 3-plane kernel."""
    ref, _, X = _case(12, 7, 9, 200, seed=17, wide_grid=300)
    X[6:12, :] = np.array([FMAX, -FMAX, 3.1e38, -3.05e38, 3.3e38, 1e38],
                          np.float32)[:, None]
    for k, one in enumerate(_leaf_id_trees(ref, extreme)):
        port = from_reference_arrays(one.trees, one.weights)
        got = fe.forest_eval_full(_t(X), port.full_pack(9, CPU)).numpy()
        want = np.asarray(ref_ensemble_eval(jnp.asarray(X), *one._pack()))
        np.testing.assert_array_equal(got, want, err_msg=f"tree {k}")
        np.testing.assert_array_equal(got, _traversal(port, X))
        if not extreme and k < 3:
            with pltpu.force_tpu_interpret_mode():
                kern = np.asarray(forest_eval_pallas_full(
                    jnp.asarray(X), *one._pack_matmul(9)))
            np.testing.assert_array_equal(got, kern, err_msg=f"tree {k}")


def _emulate_walk(pack, X):
    """What csrc/forest_eval.cu's f32 kernel computes, in torch, in its
    order: chunk by chunk (a contiguous run of f32 split records), the
    documents walk each tree of the chunk from its root record — left iff
    x <= t in f32 (NaN goes right), the child's leaf flag (bit 30 of the
    feature word for the left child, 31 for the right) ending the walk
    with the leaf's value from the record itself — at most max(max_depth,
    1) tests; one f32 partial a chunk, trees added in order."""
    X = X.to(torch.float32)
    N = X.shape[0]
    docs = torch.arange(N)
    word = pack.splits[:, 0].to(torch.int64) & 0xFFFFFFFF
    feat = word & 0x3FFFFFFF
    thr = pack.splits[:, 1].contiguous().view(torch.float32)
    kids = pack.splits[:, 2:].to(torch.int64)
    starts, roots = pack.chunk_starts, pack.split_roots
    T = roots.shape[0]
    score = torch.zeros(N)
    for c, t0 in enumerate(range(0, T, pack.tree_chunk)):
        lo, hi = int(starts[c]), int(starts[c + 1])
        assert hi - lo <= pack.chunk_splits
        partial = torch.zeros(N)
        for t in range(t0, min(t0 + pack.tree_chunk, T)):
            node = torch.full((N,), lo + int(roots[t]), dtype=torch.int64)
            live = torch.ones(N, dtype=torch.bool)
            value = torch.zeros(N)
            for _ in range(max(pack.max_depth, 1)):
                right = ~(X[docs, feat[node]] <= thr[node])
                nxt = torch.where(right, kids[node, 1], kids[node, 0])
                leaf = ((word[node] >> (30 + right.to(torch.int64))) & 1) == 1
                value = torch.where(live & leaf, nxt.to(torch.int32).view(
                    torch.float32), value)
                live = live & ~leaf
                node = torch.where(live, lo + nxt, node)
            assert not live.any()
            partial = partial + value
        score = score + partial
    return score


@pytest.mark.parametrize("extreme", [False, True])
def test_kernel_walk_over_the_f32_pack_equals_plain_bitwise(extreme):
    ref, _, X = _case(30, 7, 13, 257, seed=11, wide_grid=280)
    trees = _leaf_id_trees(ref, extreme)
    port = from_reference_arrays([one.trees[0] for one in trees],
                                 [0.1 * (1 + k % 3) for k in range(30)])
    port.add(Tree([0], [0.0], [-1], [-1], [True], [0.75]), 0.5)
    pack = port.full_pack(13, CPU)
    plain = fe.forest_eval_full(_t(X), pack)
    torch.testing.assert_close(_emulate_walk(pack, _t(X)), plain, atol=0,
                               rtol=0)


def _edge_case(case):
    """(port ensemble, n_features, X) of one f32 split-pack case."""
    if case == "one-leaf-forest":
        port = TreeEnsemble()
        for v, w in ((0.75, 0.5), (-1.5, 0.1), (3.0, 1.0)):
            port.add(Tree([0], [0.0], [-1], [-1], [True], [v]), w)
        X = np.array([[np.nan, 1.0], [0.0, -np.inf], [np.inf, 2.0]],
                     np.float32)
        return port, 2, X
    ref, port, X = _case(25, 6, 9, 200, seed=23)
    if case == "signed-zero-inf-far":
        pool = np.array([-0.0, 0.0, 3.4e38, -3.4e38, np.inf, -np.inf, FMAX,
                         -FMAX], np.float32)
        i = 0
        for t in port.trees:
            for node in np.flatnonzero(~t.is_leaf)[::2]:
                t.threshold[node] = pool[i % len(pool)]
                i += 1
        port._invalidate()
        X[20:30, :] = np.array([-0.0, 0.0, np.nan, np.inf, -np.inf, FMAX,
                                -FMAX, 3.4e38, -3.4e38, 1.0],
                               np.float32)[:, None]
    else:                                   # chains beside a one-leaf tree
        port.add(Tree([0], [0.0], [-1], [-1], [True], [0.75]), 0.5)
    return port, 9, X


@pytest.mark.parametrize("case", ["chains-and-a-leaf", "one-leaf-forest",
                                  "signed-zero-inf-far"])
def test_f32_split_pack_records_flags_and_walk(case):
    """The f32 split pack: one record an internal node (one a one-leaf
    tree), the feature and both leaf flags in the first word, the
    threshold's bits in the second, children as in the bin form; its walk
    equals the plain version bit for bit on −0.0, ±3.4e38 and ±inf
    thresholds against NaN, ±0.0, ±inf and ±FLT_MAX inputs."""
    port, F, X = _edge_case(case)
    pack = port.full_pack(F, CPU)
    internal = sum(max(int((~t.is_leaf).sum()), 1) for t in port.trees)
    assert pack.splits.shape == (internal, 4)
    assert int(pack.chunk_starts[-1]) == internal
    recs = pack.splits.numpy()
    word = recs[:, 0].view(np.uint32)
    want_word, want_thr = [], []
    for t in port.trees:
        if t.is_leaf[0]:
            want_word.append(3 << 30)
            want_thr.append(0)
            continue
        for n in np.flatnonzero(~t.is_leaf):
            want_word.append(int(t.feature[n])
                             | int(t.is_leaf[t.left[n]]) << 30
                             | int(t.is_leaf[t.right[n]]) << 31)
            want_thr.append(int(t.threshold[n:n + 1].view(np.int32)[0]))
    np.testing.assert_array_equal(word, np.asarray(want_word, np.uint32))
    np.testing.assert_array_equal(recs[:, 1], np.asarray(want_thr, np.int32))
    plain = fe.forest_eval_full(_t(X), pack)
    torch.testing.assert_close(_emulate_walk(pack, _t(X)), plain, atol=0,
                               rtol=0)
    np.testing.assert_allclose(plain.numpy(), _traversal(port, X), **TOL)


def test_f32_split_pack_refuses_a_feature_past_2_30():
    """The feature shares its word with the two leaf flags: 2^30 − 1 is
    the last feature an f32 split record holds."""
    for feature, ok in ((2**30 - 1, True), (2**30, False)):
        port = TreeEnsemble()
        port.add(Tree([feature, 0, 0], [0.5, 0, 0], [1, -1, -1],
                      [2, -1, -1], [False, True, True], [0, 1.0, 2.0]), 1.0)
        if ok:
            splits = port._pack_splits(2**30 + 1, f32=True)[0]
            assert int(splits[0, 0]) & 0x3FFFFFFF == feature
        else:
            with pytest.raises(RankLibError, match="2\\^30"):
                port._pack_splits(2**30 + 1, f32=True)


def test_route_selection_takes_the_f32_kernel_on_cuda(monkeypatch):
    """The repaired fault: a CUDA device with a 300-threshold model (or
    an input wider than MAX_FEATURES) now takes the f32 kernel, where it
    raised before; within the bin kernels' limits nothing changes."""
    _, small, _ = _case(10, 5, 6, 8, seed=1)
    _, wide_grid, X = _case(110, 7, 13, 64, seed=11, wide_grid=300)
    assert small.serving_route(6, "cuda") == ("bins", 1 << 20)
    assert small.serving_route(6, "cpu") == ("bins", 1 << 20)
    assert wide_grid._bins_grid_meta()[1] > 256
    assert wide_grid.serving_route(13, "cuda") == ("f32", 1 << 20)
    assert wide_grid.serving_route(13, "cpu") == ("f32", 1 << 14)
    assert small.serving_route(fe.MAX_FEATURES + 1, "cuda")[0] == "f32"
    # the CUDA-typed route with its pack built on the CPU: the f32 wrapper
    built, full_pack = [], TreeEnsemble.full_pack

    def cpu_pack(self, n_features, device):
        built.append(device.type)
        return full_pack(self, n_features, CPU)

    monkeypatch.setattr(TreeEnsemble, "full_pack", cpu_pack)
    fn, chunk = wide_grid._device_eval_fn(13, torch.device("cuda"))
    assert built == ["cuda"] and chunk == 1 << 20
    np.testing.assert_allclose(fn(_t(X)).numpy(), _traversal(wide_grid, X),
                               **TOL)


def test_input_wider_than_max_features_scores_on_the_f32_route():
    F = fe.MAX_FEATURES + 9
    ref, port, X = _case(20, 6, F, 40, seed=4)
    assert not port._use_bins_kernel(F)
    got = port.eval_matrix(X, CPU)
    np.testing.assert_allclose(got, _traversal(port, X), **TOL)
    np.testing.assert_allclose(got, ref.eval_matrix(X), **TOL)


def test_full_wrapper_checks_inputs_and_counts_only_kernel_launches():
    _, port, X = _case(5, 4, 6, 40, seed=1, wide_grid=300)
    pack = port.full_pack(6, CPU)
    before = fe.forest_eval_full.launches
    fe.forest_eval_full(_t(X), pack)
    assert fe.forest_eval_full.launches == before     # CPU: plain version
    bad = [
        lambda: fe.forest_eval_full(_t(X).double(), pack),
        lambda: fe.forest_eval_full(_t(X)[:, :5].contiguous(), pack),
        lambda: fe.forest_eval_full(_t(X).T.contiguous().T, pack),
        # neither CPU nor CUDA: raises, never falls back to the plain path
        lambda: fe.forest_eval_full(_t(X).to("meta"), pack),
    ]
    for call in bad:
        with pytest.raises(RankLibError):
            call()
    with pytest.raises(RankLibError, match="feature outside"):
        port.eval_matrix(X[:, :1], CPU)
