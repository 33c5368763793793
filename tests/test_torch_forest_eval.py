"""The port's bin-space forest evaluators (ranklib_tpu_torch.ops.forest_eval)
against the reference's Pallas kernels and its XLA scan path.

Inputs come from numpy seeds and go through both packages: the reference's
``forest_eval_pallas_bins``/``_frombins`` in TPU-interpret mode (as
tests/test_forest_eval.py runs them) and ``_mm_eval``; the port's plain
PyTorch versions on the CPU. The CUDA kernels themselves run only on a card
(chip_smoke.py holds them to these plain versions); here Python
emulations of their binning and split-record walk pin the pack they read
and the order they add in.
Tolerance 1e-5, the reference kernel tests' own.
"""

import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import __graft_entry__ as g
from ranklib_tpu.gbdt.binning import bin_features as ref_bin_features
from ranklib_tpu.gbdt.ensemble import _mm_eval
from ranklib_tpu.ops.forest_eval import (
    forest_eval_pallas_bins, forest_eval_pallas_frombins,
)
from ranklib_tpu_torch.convert import from_reference_arrays
from ranklib_tpu_torch.gbdt.ensemble import Tree
from ranklib_tpu_torch.ops import _build
from ranklib_tpu_torch.ops import forest_eval as fe
from ranklib_tpu_torch.utils.errors import RankLibError

CPU = torch.device("cpu")
TOL = {"atol": 1e-5, "rtol": 1e-5}


def _case(n_trees, n_leaves, n_features, n_docs, seed):
    rng = np.random.default_rng(seed)
    ref = g._synthetic_ensemble(n_trees=n_trees, n_leaves=n_leaves,
                                n_features=n_features, rng=rng)
    X = rng.normal(size=(n_docs, n_features)).astype(np.float32)
    return ref, from_reference_arrays(ref.trees, ref.weights), X, rng


def _hostile(ref, X, rng):
    """Docs ON split thresholds, NaN and ±inf features."""
    X = X.copy()
    thrs = np.concatenate([t.threshold[~t.is_leaf] for t in ref.trees])
    flat = X.reshape(-1)
    pick = rng.integers(0, len(thrs), size=len(flat) // 2)
    flat[: len(pick)] = thrs[pick]
    X[::17, 3 % X.shape[1]] = np.nan
    X[5, 2 % X.shape[1]] = np.inf
    X[6, 1 % X.shape[1]] = -np.inf
    return X


def _ref_mm(ref, X):
    return np.asarray(_mm_eval(jnp.asarray(X),
                               *ref._pack_matmul(X.shape[1])))


def _t(a):
    return torch.from_numpy(np.array(a))          # writable copy


@pytest.mark.parametrize("shape", [(50, 10, 20, 300, 7), (23, 7, 13, 257, 11)],
                         ids=["50x10", "odd-23x7"])
def test_bins_plain_matches_reference_kernel(shape):
    ref, port, X, rng = _case(*shape)
    X = _hostile(ref, X, rng)
    F = X.shape[1]
    *binpack, n_grid = ref._pack_matmul_bins(F)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(forest_eval_pallas_bins(jnp.asarray(X), *binpack,
                                                  n_grid=n_grid))
    # like with like: the plain version on the REFERENCE's operands ...
    got_ref_ops = fe.forest_eval_bins_plain(
        _t(X), *map(_t, binpack), n_grid=int(n_grid),
        tree_chunk=port._TREE_CHUNK).numpy()
    # ... and the wrapper on a CPU tensor with the port's own pack
    got = fe.forest_eval_bins(_t(X), port.forest_pack(F, CPU)).numpy()
    np.testing.assert_allclose(got_ref_ops, want, **TOL)
    np.testing.assert_array_equal(got, got_ref_ops)
    np.testing.assert_allclose(got, _ref_mm(ref, X), **TOL)


def test_bins_plain_exact_at_split_boundaries():
    ref, port, _, _ = _case(23, 7, 13, 8, seed=11)
    rng = np.random.default_rng(13)
    thrs = np.concatenate([t.threshold[~t.is_leaf] for t in ref.trees])
    X = rng.normal(size=(512, 13)).astype(np.float32)
    flat = X.reshape(-1)
    pick = rng.integers(0, len(thrs), size=len(flat) // 2)
    flat[: len(pick)] = thrs[pick]
    got = fe.forest_eval_bins(_t(X), port.forest_pack(13, CPU)).numpy()
    np.testing.assert_allclose(got, _ref_mm(ref, X), **TOL)


@pytest.mark.parametrize("dtype", [np.uint8, np.int16])
def test_frombins_plain_matches_reference_kernel(dtype):
    ref, port, X, rng = _case(50, 10, 20, 300, seed=7)
    X = _hostile(ref, X, rng)
    grid_np = ref._model_grid_np(20)
    _g, fid_full, nodebin, PmQc, csQc, plenc, outwc, n_grid = (
        ref._pack_matmul_bins(20))
    assert n_grid < 256
    bins = ref_bin_features(X, grid_np)
    bins[np.isnan(X)] = n_grid
    binsT = np.ascontiguousarray(np.minimum(bins, n_grid).astype(dtype).T)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(forest_eval_pallas_frombins(
            jnp.asarray(binsT), fid_full, nodebin, PmQc, csQc, plenc, outwc))
    got = fe.forest_eval_frombins(_t(binsT), port.forest_pack(20, CPU))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), _ref_mm(ref, X), **TOL)


def _grid256_case():
    """Every split on feature 0 with 256 distinct thresholds: ids reach
    256 (docs above every threshold, NaN), which only int16 holds."""
    rng = np.random.default_rng(5)
    ref = g._synthetic_ensemble(n_trees=60, n_leaves=6, n_features=12,
                                rng=rng)
    pool = np.linspace(-2.0, 2.0, 256).astype(np.float32)
    i = 0
    for t in ref.trees:
        for n in np.flatnonzero(~t.is_leaf):
            t.feature[n] = 0
            t.threshold[n] = pool[i % 256]
            i += 1
    X = rng.normal(size=(400, 12)).astype(np.float32)
    X[7, 0] = 5.0
    X[11, 0] = np.nan
    return ref, from_reference_arrays(ref.trees, ref.weights), X


def test_frombins_int16_ids_at_grid_256():
    ref, port, X = _grid256_case()
    pack = port.forest_pack(12, CPU)
    assert pack.n_grid == 256
    ids = fe.device_bins(_t(X), pack.grid, pack.n_grid)
    assert int(ids.max()) == 256              # would wrap to 0 in uint8
    _g, fid_full, nodebin, PmQc, csQc, plenc, outwc, n_grid = (
        ref._pack_matmul_bins(12))
    binsT = ids.to(torch.int16).contiguous()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(forest_eval_pallas_frombins(
            jnp.asarray(binsT.numpy()), fid_full, nodebin, PmQc, csQc, plenc,
            outwc))
    got = fe.forest_eval_frombins(binsT, pack).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _ref_mm(ref, X), **TOL)
    np.testing.assert_array_equal(
        fe.forest_eval_bins(_t(X), pack).numpy(), got)


def test_lone_leaf_tree_scores_its_output():
    ref, port, X, _ = _case(7, 3, 5, 33, seed=3)
    leaf = Tree([0], [0.0], [-1], [-1], [True], [0.75])
    port.add(leaf, 0.5)
    ref.add(type(ref.trees[0])([0], [0.0], [-1], [-1], [True], [0.75]), 0.5)
    got = fe.forest_eval_bins(_t(X), port.forest_pack(5, CPU)).numpy()
    np.testing.assert_allclose(got, _ref_mm(ref, X), **TOL)


def _emulate_split_walk(pack, binsT):
    """What the frombins kernel computes, in torch, in its order: chunk by
    chunk (a contiguous run of split records), the warp's documents walk
    each tree of the chunk in turn from its root record — right iff id >
    node bin, the child's leaf flag ending the walk with the leaf's value
    from the record itself — at most max(max_depth, 1) tests; one f32
    partial a chunk, trees added in order."""
    bins = binsT.to(torch.int64)
    N = bins.shape[1]
    docs = torch.arange(N)
    recs = pack.splits.to(torch.int64)
    starts, roots = pack.chunk_starts, pack.split_roots
    T = roots.shape[0]
    score = torch.zeros(N)
    for c, t0 in enumerate(range(0, T, pack.tree_chunk)):
        cr = recs[int(starts[c]):int(starts[c + 1])]
        assert cr.shape[0] <= pack.chunk_splits
        partial = torch.zeros(N)
        for t in range(t0, min(t0 + pack.tree_chunk, T)):
            node = torch.full((N,), int(roots[t]), dtype=torch.int64)
            live = torch.ones(N, dtype=torch.bool)
            value = torch.zeros(N)
            for _ in range(max(pack.max_depth, 1)):
                r = cr[node]
                right = bins[r[:, 0], docs] > (r[:, 1] & 0xFFFF)
                nxt = torch.where(right, r[:, 3], r[:, 2])
                leaf = ((r[:, 1] >> (16 + right.to(torch.int64))) & 1) == 1
                value = torch.where(live & leaf, nxt.to(torch.int32).view(
                    torch.float32), value)
                live = live & ~leaf
                node = torch.where(live, nxt, node)
            assert not live.any()
            partial = partial + value
        score = score + partial
    return score


def _emulate_walk(pack, X):
    """What the bins kernel computes, in torch, in its order: each value
    binned as its binary search does — #{grid_f < x} over the first
    n_grid grid entries, NaN → n_grid — into the id type it stages (uint8,
    int16 at n_grid 256), then the frombins kernel's split walk over those
    ids. Returns (ids [F, N], scores [N])."""
    XT = X.T
    grid = pack.grid[:, :pack.n_grid]
    ids = (grid[:, None, :] < XT[:, :, None]).sum(dim=2)
    ids = torch.where(torch.isnan(XT), pack.n_grid, ids)
    ids = ids.to(torch.int16 if pack.n_grid >= 256 else torch.uint8)
    return ids, _emulate_split_walk(pack, ids)


@pytest.mark.parametrize("which", ["odd", "grid256"])
def test_kernel_walk_over_the_pack_equals_plain_bitwise(which):
    """The bins kernel's binning and split walk against its plain version,
    atol 0: odd shapes with hostile features and a one-leaf tree (uint8
    ids), and ids reaching 256 at n_grid 256 (int16)."""
    if which == "odd":
        ref, port, X, rng = _case(23, 7, 13, 257, seed=11)
        X = _hostile(ref, X, rng)
        port.add(Tree([0], [0.0], [-1], [-1], [True], [0.75]), 0.5)
    else:
        _, port, X = _grid256_case()
    pack = port.forest_pack(X.shape[1], CPU)
    ids, got = _emulate_walk(pack, _t(X))
    assert ids.dtype == (torch.int16 if which == "grid256" else torch.uint8)
    assert torch.equal(ids.to(torch.int32),
                       fe.device_bins(_t(X), pack.grid, pack.n_grid))
    torch.testing.assert_close(got, fe.forest_eval_bins(_t(X), pack),
                               atol=0, rtol=0)


@pytest.mark.parametrize("which", ["odd", "grid256", "one-leaf"])
def test_split_records_walked_in_kernel_order_equal_plain_bitwise(which):
    """The frombins kernel's pack and order against the plain version,
    atol 0: odd shapes with hostile features and a one-leaf tree, int16
    ids at n_grid 256, and a forest of one-leaf trees only."""
    if which == "odd":
        ref, port, X, rng = _case(23, 7, 13, 257, seed=11)
        X = _hostile(ref, X, rng)
        port.add(Tree([0], [0.0], [-1], [-1], [True], [0.75]), 0.5)
    elif which == "grid256":
        _, port, X = _grid256_case()
    else:
        _, port, X, _ = _case(1, 2, 5, 40, seed=2)
        port.truncate(0)
        for v in (0.75, -1.5, 3.0):
            port.add(Tree([0], [0.0], [-1], [-1], [True], [v]), 0.5)
    F = X.shape[1]
    pack = port.forest_pack(F, CPU)
    internal = sum(max(int((~t.is_leaf).sum()), 1) for t in port.trees)
    assert pack.splits.shape == (internal, 4)
    assert int(pack.chunk_starts[-1]) == internal
    ids = fe.device_bins(_t(X), pack.grid, pack.n_grid)
    dt = torch.int16 if pack.n_grid >= 256 else torch.uint8
    plain = fe.forest_eval_frombins(ids.to(dt).contiguous(), pack)
    torch.testing.assert_close(_emulate_split_walk(pack, ids), plain,
                               atol=0, rtol=0)


def test_walk_packs_refuse_bad_features_and_links():
    """A split on a feature past the input's width or a child outside its
    tree would make the kernels read out of bounds: both packs raise."""
    for field, bad in (("feature", 6), ("left", 40)):
        _, port, _, _ = _case(3, 4, 6, 8, seed=1)
        tree = port.trees[1]
        n = int(np.flatnonzero(~tree.is_leaf)[0])
        getattr(tree, field)[n] = bad
        port._invalidate()
        with pytest.raises(RankLibError, match="outside"):
            port._pack_walk(6)
        with pytest.raises(RankLibError, match="outside"):
            port._pack_splits(6)
        with pytest.raises(RankLibError, match="outside"):
            port._pack_splits(6, f32=True)


def test_wrappers_check_inputs_and_count_only_kernel_launches():
    _, port, X, _ = _case(5, 4, 6, 40, seed=1)
    pack = port.forest_pack(6, CPU)
    ids = fe.device_bins(_t(X), pack.grid, pack.n_grid).to(torch.uint8)
    before = (fe.forest_eval_frombins.launches, fe.forest_eval_bins.launches)
    fe.forest_eval_frombins(ids.contiguous(), pack)
    fe.forest_eval_bins(_t(X), pack)
    assert (fe.forest_eval_frombins.launches,
            fe.forest_eval_bins.launches) == before   # CPU: plain version
    bad = [
        lambda: fe.forest_eval_frombins(ids.to(torch.int32), pack),
        lambda: fe.forest_eval_frombins(ids[:3].contiguous(), pack),
        lambda: fe.forest_eval_frombins(ids.T.contiguous().T, pack),
        lambda: fe.forest_eval_bins(_t(X).double(), pack),
        lambda: fe.forest_eval_bins(_t(X)[:, :5].contiguous(), pack),
        lambda: fe.forest_eval_bins(_t(X).T.contiguous().T, pack),
        # neither CPU nor CUDA: raises, never falls back to the plain path
        lambda: fe.forest_eval_bins(_t(X).to("meta"), pack),
        lambda: fe.forest_eval_frombins(ids.contiguous().to("meta"), pack),
    ]
    for call in bad:
        with pytest.raises(RankLibError):
            call()


def test_find_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    real_isfile = os.path.isfile
    monkeypatch.setattr(_build.os.path, "isfile",
                        lambda p: p.startswith(str(tmp_path))
                        and real_isfile(p))
    with pytest.raises(RankLibError, match="nvcc not found"):
        _build.find_nvcc()
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    assert _build.find_nvcc() == str(nvcc)


def test_compile_shared_builds_once_and_reports_errors(monkeypatch,
                                                       tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "k.c"
    src.write_text("int answer(void) { return 42; }\n")
    cmd = ("gcc", "-O1", "-shared", "-fPIC")
    path = _build.compile_shared("k", cmd, (str(src),))
    mtime = os.path.getmtime(path)
    assert _build.compile_shared("k", cmd, (str(src),)) == path
    assert os.path.getmtime(path) == mtime       # cached by content hash
    import ctypes
    assert ctypes.CDLL(path).answer() == 42
    src.write_text("int answer(void) { return }\n")
    with pytest.raises(RankLibError, match="building k failed"):
        _build.compile_shared("k", cmd, (str(src),))
