"""The port's split bin-space route and predicate epilogue
(ranklib_tpu_torch.ops.forest_eval) against the reference.

* Split route (``device_bins_narrow`` then ``forest_eval_frombins``, what
  ``RANKLIB_TPU_SERVE_SPLIT=1`` serves): the plain route on the CPU against
  the reference's ``forest_eval_pallas_bins_split`` in TPU-interpret mode
  and against its ``_mm_eval`` scan, on documents that sit on thresholds,
  NaN and ±inf features, and a 256-threshold grid whose ids need int16.
* The binning kernel: a numpy emulation of its fixed-trip search and
  packed id words against ``device_bins`` and the reference's
  ``_bins_only_kernel`` bit for bit (±0.0, ±inf, NaN, 1-256 thresholds,
  uint8 and int16 ids, N and F off the kernel's tiles).
* ``eval_matrix`` and the CLI under the flag: the same scores as the
  default route.
* Predicate epilogue (``forest_eval_pred``): the plain version against the
  reference's ``forest_eval_pallas`` in interpret mode with bf16 node tests,
  as tests/test_forest_eval.py:44-53 drives it; a torch emulation of the
  CUDA kernel's loop (the packs' path lists, hits counted 4 documents a
  word) against the plain version bit for bit, on chain, heap-shaped,
  one-leaf and 150-leaf trees; the path lists against P−Q's nonzeros.

Inputs come from numpy seeds. Tolerance 1e-5, the reference kernel tests'
own; the port's routes among themselves agree bit for bit.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import __graft_entry__ as g
from ranklib_tpu.gbdt.ensemble import _mm_eval
from ranklib_tpu.ops.forest_eval import (
    forest_eval_pallas, forest_eval_pallas_bins_split,
)
from ranklib_tpu_torch.convert import from_reference_arrays
from ranklib_tpu_torch.gbdt import ensemble as E
from ranklib_tpu_torch.ops import forest_eval as fe
from ranklib_tpu_torch.utils.errors import RankLibError

CPU = torch.device("cpu")
TOL = {"atol": 1e-5, "rtol": 1e-5}
SPLIT = "RANKLIB_TPU_SERVE_SPLIT"


def _case(n_trees, n_leaves, n_features, n_docs, seed, grid256=False):
    """A reference ensemble, its port, and hostile features: docs on
    thresholds, NaN and ±inf; with ``grid256`` every split sits on feature
    0 with 256 distinct thresholds (ids reach 256)."""
    rng = np.random.default_rng(seed)
    ref = g._synthetic_ensemble(n_trees=n_trees, n_leaves=n_leaves,
                                n_features=n_features, rng=rng)
    if grid256:
        pool = np.linspace(-2.0, 2.0, 256).astype(np.float32)
        i = 0
        for t in ref.trees:
            for n in np.flatnonzero(~t.is_leaf):
                t.feature[n], t.threshold[n] = 0, pool[i % 256]
                i += 1
    X = rng.normal(size=(n_docs, n_features)).astype(np.float32)
    thrs = np.concatenate([t.threshold[~t.is_leaf] for t in ref.trees])
    flat = X.reshape(-1)
    pick = rng.integers(0, len(thrs), size=len(flat) // 2)
    flat[: len(pick)] = thrs[pick]
    if n_docs > 11:
        X[::17, 3 % n_features] = np.nan
        X[5, 2 % n_features] = np.inf
        X[6, 1 % n_features] = -np.inf
        X[7, 0] = 5.0                             # past every threshold
        X[11, 0] = np.nan
    return ref, from_reference_arrays(ref.trees, ref.weights), X


def _ref_mm(ref, X):
    return np.asarray(_mm_eval(jnp.asarray(X),
                               *ref._pack_matmul(X.shape[1])))


CASES = {"50x10": (50, 10, 20, 300, 7), "odd-23x7": (23, 7, 13, 257, 11),
         "grid256": (60, 6, 12, 400, 5, True)}


@pytest.mark.parametrize("which", list(CASES))
def test_split_route_matches_reference_kernel(which):
    ref, port, X = _case(*CASES[which])
    F = X.shape[1]
    pack = port.forest_pack(F, CPU)
    Xt = torch.from_numpy(X)
    ids = fe.device_bins_narrow(Xt, pack)
    assert ids.dtype == (torch.int16 if which == "grid256" else torch.uint8)
    assert ids.shape == (F, X.shape[0])
    torch.testing.assert_close(ids.to(torch.int32),
                               fe.device_bins(Xt, pack.grid, pack.n_grid),
                               atol=0, rtol=0)
    *binpack, n_grid = ref._pack_matmul_bins(F)
    assert n_grid == pack.n_grid
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(forest_eval_pallas_bins_split(
            jnp.asarray(X), *binpack, n_grid=n_grid))
    got = fe.forest_eval_bins_split(Xt, pack)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), _ref_mm(ref, X), **TOL)
    # bit-equal to the fused device route and to its own plain chain
    torch.testing.assert_close(got, fe.forest_eval_bins(Xt, pack), atol=0,
                               rtol=0)
    torch.testing.assert_close(got, fe.forest_eval_frombins_plain(
        ids, *pack.matmul_operands(), tree_chunk=pack.tree_chunk), atol=0,
        rtol=0)


def _emulate_bins_only(X, grid, n_grid):
    """What csrc/forest_eval.cu bins_only_kernel computes: with steps =
    ceil(log2(n_grid + 1)), the grid row padded with +inf to 2^steps − 1
    entries and laid out in Eytzinger (breadth-first) order — node k's
    in-order index is ((2(k − 2^level) + 1) << (steps − 1 − level)) − 1,
    then a fixed trip of ``steps`` branchless steps k = 2k + (eyt[k − 1]
    < x), the count being k − 2^steps; past 9 steps the sorted row itself,
    searched by halving steps. NaN → n_grid. Then 4 consecutive
    documents' ids packed in one little-endian word (uint8: 32 bits,
    int16: 64 bits), documents past the last whole word stored one by
    one. Returns the ids [F, N] as the kernel's id type."""
    N, F = X.shape
    steps = int(n_grid).bit_length()
    x = X.T
    if steps <= 9:
        k = np.arange(1, 1 << steps)
        level = np.floor(np.log2(k)).astype(np.int64)
        j = ((2 * (k - (1 << level)) + 1) << (steps - 1 - level)) - 1
        eyt = np.full((F, k.size), np.inf, np.float32)
        real = j < n_grid
        eyt[:, real] = grid[:, j[real]]
        node = np.ones((F, N), np.int64)
        for _ in range(steps):
            probe = np.take_along_axis(eyt, node - 1, axis=1)
            node = 2 * node + (probe < x)
        pos = node - (1 << steps)
    else:
        pos = np.zeros((F, N), np.int64)
        step = (1 << steps) >> 1
        while step:
            i = pos + step - 1
            probe = np.take_along_axis(grid, np.minimum(i, n_grid - 1), 1)
            pos += np.where((i < n_grid) & (probe < x), step, 0)
            step >>= 1
    b = np.where(np.isnan(x), n_grid, pos).astype(np.uint32)
    dt = np.uint8 if n_grid < 256 else np.int16
    whole = N // 4 * 4
    q = [b[:, j:whole:4] for j in range(4)]
    if dt == np.uint8:
        words = q[0] | q[1] << 8 | q[2] << 16 | q[3] << 24
        body = words.astype("<u4").view(np.uint8)
    else:
        lo = (q[0] & 0xFFFF) | q[1] << 16
        hi = (q[2] & 0xFFFF) | q[3] << 16
        body = np.stack([lo, hi], axis=-1).astype("<u4").reshape(
            F, -1).view("<i2")
    return np.concatenate([body.reshape(F, whole),
                           b[:, whole:].astype(dt)], axis=1).astype(dt)


def _ref_bins_only(X, grid, n_grid):
    """The reference's ``_bins_only_kernel`` on all of X^T in one block,
    in TPU-interpret mode: bf16 ids, exact below 257."""
    import functools

    import jax
    from jax.experimental import pallas as pl

    from ranklib_tpu.ops.forest_eval import _bins_only_kernel

    F = X.shape[1]
    XT = jnp.asarray(np.ascontiguousarray(X.T))
    with pltpu.force_tpu_interpret_mode():
        ids = pl.pallas_call(
            functools.partial(_bins_only_kernel, n_grid=int(n_grid),
                              n_rows=F),
            out_shape=jax.ShapeDtypeStruct(XT.shape, jnp.bfloat16),
        )(XT, jnp.asarray(grid))
    return np.asarray(ids.astype(jnp.float32)).astype(np.int64)


def _hostile_grid(F, n_grid, seed):
    """Sorted grid rows of up to ``n_grid`` thresholds (+inf pads past
    each row's count, 0.0 among them) and features on, between and past
    them: ±0.0, ±inf, NaN."""
    rng = np.random.default_rng(seed)
    grid = np.full((F, n_grid), np.inf, np.float32)
    for f in range(F):
        k = n_grid if f % 3 else int(rng.integers(1, n_grid + 1))
        vals = np.unique(np.concatenate([[0.0], rng.normal(size=k) * 2]))
        grid[f, :k] = np.sort(vals[:k]).astype(np.float32)
    N = 203                                 # not a multiple of 4
    X = rng.normal(size=(N, F)).astype(np.float32) * 2
    on = grid[np.arange(F), rng.integers(0, n_grid, size=F)]
    X[:F, :] = np.where(np.isfinite(on), on, 1.0)[None, :]
    X[F:F + 6] = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e30],
                          np.float32)[:, None]
    return X, grid


@pytest.mark.parametrize("n_grid", [1, 7, 88, 255, 256, 600])
def test_bins_only_emulation_matches_device_bins_and_reference(n_grid):
    """B8's fixed-trip search and packed stores, emulated, give the ids of
    ``device_bins`` and of the reference's ``_bins_only_kernel``, bit for
    bit, uint8 below 256 thresholds and int16 from 256 (600: the grid
    searched in global memory, past the integers the reference's bf16 ids
    hold, so against ``device_bins`` only); on F = 13 (not a multiple of
    the kernel's 16 features a block) and N = 203 documents."""
    X, grid = _hostile_grid(13, n_grid, seed=n_grid)
    emu = _emulate_bins_only(X, grid, n_grid)
    assert emu.dtype == (np.uint8 if n_grid < 256 else np.int16)
    plain = fe.device_bins(torch.from_numpy(X), torch.from_numpy(grid),
                           n_grid).numpy()
    np.testing.assert_array_equal(emu.astype(np.int64), plain)
    if n_grid <= 256:          # the reference's bf16 ids stop at 256
        np.testing.assert_array_equal(emu.astype(np.int64),
                                      _ref_bins_only(X, grid, n_grid))


@pytest.mark.parametrize("which", list(CASES))
def test_bins_only_emulation_on_model_grids(which):
    """The same emulation on the models' own grids and hostile features,
    its ids through the frombins walk: the split route's scores and the
    reference's ``forest_eval_pallas_bins_split``."""
    ref, port, X = _case(*CASES[which])
    F = X.shape[1]
    pack = port.forest_pack(F, CPU)
    emu = _emulate_bins_only(X, pack.grid.numpy(), pack.n_grid)
    ids = fe.device_bins_narrow(torch.from_numpy(X), pack)
    np.testing.assert_array_equal(emu, ids.numpy())
    np.testing.assert_array_equal(
        emu.astype(np.int64), _ref_bins_only(X, pack.grid.numpy(),
                                             pack.n_grid))
    got = fe.forest_eval_frombins_plain(
        torch.from_numpy(emu), *pack.matmul_operands(),
        tree_chunk=pack.tree_chunk)
    *binpack, n_grid = ref._pack_matmul_bins(F)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(forest_eval_pallas_bins_split(
            jnp.asarray(X), *binpack, n_grid=n_grid))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_serving_route_and_eval_matrix_under_the_flag(monkeypatch):
    _, port, X = _case(37, 7, 12, 600, seed=3)
    monkeypatch.delenv(SPLIT, raising=False)
    assert port.serving_route(12, "cuda")[0] == "bins"
    want = port.eval_matrix(X, CPU)
    calls = []
    real = E.forest_eval_bins_split
    monkeypatch.setattr(E, "forest_eval_bins_split",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(E.TreeEnsemble, "_KERNEL_CHUNK", 256)
    monkeypatch.setenv(SPLIT, "1")
    assert port.serving_route(12, "cuda")[0] == "bins_split"
    got = port.eval_matrix(X, CPU)
    assert len(calls) == 3                     # 600 docs in calls of 256
    np.testing.assert_array_equal(got, want)
    # a model the bin-space kernels do not take keeps the f32 route
    wide, _, _ = _case(8, 4, 3, 8, seed=2)
    wide = from_reference_arrays(wide.trees, wide.weights)
    monkeypatch.setattr(E, "MAX_GRID", 2)
    assert wide.serving_route(3, "cuda")[0] == "f32"


def test_cli_load_test_under_the_flag(monkeypatch, tmp_path, capsys):
    from ranklib_tpu_torch.cli import main
    from ranklib_tpu_torch.models.gbdt import LambdaMART
    from tests.fixtures import synth_dataset, write_letor_text

    monkeypatch.setenv("RANKLIB_TPU_TORCH_DEVICE", "cpu")
    _, port, _ = _case(20, 6, 8, 8, seed=9)
    model, test = str(tmp_path / "m.txt"), str(tmp_path / "t.txt")
    r = LambdaMART()
    r.ensemble = port
    r.save(model)
    write_letor_text(synth_dataset(n_queries=6, n_features=8, seed=4), test)
    lines = []
    for flag in ("0", "1"):
        monkeypatch.setenv(SPLIT, flag)
        assert main(["-load", model, "-test", test, "-metric2T",
                     "NDCG@10"]) == 0
        lines.append([ln for ln in capsys.readouterr().out.splitlines()
                      if "on test data" in ln])
    assert lines[0] == lines[1] and lines[0]


def _pred_case(n_trees, n_leaves, n_features, n_docs, seed):
    ref, port, X = _case(n_trees, n_leaves, n_features, n_docs, seed)
    fid, thr, PmQc, csQc, plenc, outwc = ref._pack_matmul(n_features)
    valsT = jnp.take(jnp.asarray(X).T, fid, axis=0)
    predT = (valsT <= thr[:, None]).astype(jnp.bfloat16)
    return ref, port, X, predT, (PmQc, csQc, plenc, outwc)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(50, 10, 20, 300, 7), (23, 7, 13, 257, 11)],
                         ids=["50x10", "odd-23x7"])
def test_pred_plain_matches_reference_kernel(shape):
    ref, port, X, predT, ops = _pred_case(*shape)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(forest_eval_pallas(predT, *ops))
    pack = port.full_pack(X.shape[1], CPU)
    # the port's pack holds the operands the reference kernel was given
    for mine, theirs in zip(pack.matmul_operands()[2:], ops):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    p_bf16 = _t(predT.astype(jnp.float32)).to(torch.bfloat16)
    got = fe.forest_eval_pred(p_bf16, pack)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), _ref_mm(ref, X), **TOL)
    # uint8 node tests, and the f32 route on the same model: bit-equal
    torch.testing.assert_close(fe.forest_eval_pred(
        p_bf16.to(torch.uint8), pack), got, atol=0, rtol=0)
    torch.testing.assert_close(fe.forest_eval_full_plain(
        torch.from_numpy(X), *pack.matmul_operands(),
        tree_chunk=pack.tree_chunk), got, atol=0, rtol=0)


def _emulate_pred_kernel(predT, paths, csQc, plenc, outwc, tree_chunk, M,
                         packed_max=127):
    """What csrc/forest_eval.cu pred_epilogue_kernel computes, in torch:
    node tests as one byte a document (bf16: 1 where nonzero), 4 documents
    a 32-bit word; per leaf l of tree t = c·tree_chunk + j, its path list
    from the tree's record ``paths[t]`` (offsets ``[:L + 1]``, P counts
    ``[L + 1:2L + 1]``, then each leaf's P rows and Q rows m, the tree's
    node row j·M + m). Paths of at most ``packed_max`` entries count the 4
    documents' hits in the bytes of one word (±word, mod 2^32) and match
    where the byte of ``acc + 0x80808080 − t·0x01010101`` is 0x80, for
    t = plen − csQ an integer in [−nQ, nP]; longer ones count each
    document's int hits and match where float(hits) == plen − csQ.
    Matching outputs add in leaf order, trees in order into one partial a
    chunk, chunks in order."""
    nch, TCL = csQc.shape
    L, TCM = TCL // tree_chunk, predT.shape[0] // nch
    b = (predT != 0 if predT.dtype == torch.bfloat16 else predT).to(
        torch.int64)
    N = b.shape[1]
    Np = -(-N // 4) * 4
    b = torch.nn.functional.pad(b, (0, Np - N))
    words = (b.view(b.shape[0], Np // 4, 4)
             * torch.tensor([1, 1 << 8, 1 << 16, 1 << 24])).sum(-1)
    mask = 0xFFFFFFFF
    score = torch.zeros(Np)
    for c in range(nch):
        partial = torch.zeros(Np)
        for j in range(tree_chunk):
            rec = paths[c * tree_chunk + j].to(torch.int64)
            leaf = torch.zeros(Np)
            for l_ in range(L):
                cl = j * L + l_
                p0, p1 = int(rec[l_]), int(rec[l_ + 1])
                m = rec[2 * L + 1 + p0:2 * L + 1 + p1]
                neg = (torch.arange(p1 - p0) >= int(rec[L + 1 + l_])).long()
                assert bool(((m >= 0) & (m < M)).all())
                rows = c * TCM + j * M + m
                sign = 1 - 2 * neg
                adj = plenc[c, cl] - csQc[c, cl]          # f32, as plain
                o = outwc[c, cl]
                if p1 - p0 <= packed_max:
                    acc = (sign[:, None] * words[rows]).sum(0) & mask
                    nq = int(neg.sum())
                    a = float(adj)
                    if a != int(a) or not -nq <= a <= p1 - p0 - nq:
                        continue
                    cst = (0x80808080 - int(a) * 0x01010101) & mask
                    v = ((acc + cst) & mask) ^ 0x80808080
                    byte = (v[:, None] >> torch.tensor([0, 8, 16, 24])) & 0xFF
                    hit = (byte == 0).reshape(-1)
                else:
                    hits = (sign[:, None] * b[rows]).sum(0)
                    hit = hits.to(torch.float32) == adj
                leaf = torch.where(hit, leaf + o, leaf)
            partial = partial + leaf
        score = score + partial
    return score[:N]


def _emulate(p, pack, packed_max=127):
    return _emulate_pred_kernel(p, pack.pred_paths, pack.csQc, pack.plenc,
                                pack.outwc, pack.tree_chunk,
                                pack.nodes_per_tree, packed_max)



def test_pred_kernel_loop_over_diagonal_blocks_equals_plain_bitwise():
    _, port, X, predT, ops = _pred_case(23, 7, 13, 257, seed=11)
    pack = port.full_pack(13, CPU)
    p = _t(predT.astype(jnp.float32)).to(torch.uint8)
    ops = tuple(map(_t, ops))
    plain = fe.forest_eval_pred_plain(p, *ops, tree_chunk=pack.tree_chunk)
    torch.testing.assert_close(_emulate(p, pack), plain, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16],
                         ids=["uint8", "bf16"])
@pytest.mark.parametrize("shape", [(50, 10, 20, 300, 7), (23, 7, 13, 257, 11)],
                         ids=["50x10", "odd-23x7"])
def test_pred_kernel_emulation_matches_plain_and_reference(shape, dtype):
    """The kernel's loop (path lists, hits counted 4 documents a word)
    against the plain version, bit for bit, and the reference's
    forest_eval_pallas in interpret mode, on both predicate cases, uint8
    and bf16 node tests. The reference folds the leaf outputs of a chunk
    in one product (another order of f32 adds), so it agrees to the
    reference kernel tests' 1e-5."""
    _, port, X, predT, ops = _pred_case(*shape)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(forest_eval_pallas(predT, *ops))
    pack = port.full_pack(X.shape[1], CPU)
    p = _t(predT.astype(jnp.float32)).to(dtype)
    emu = _emulate(p, pack)
    torch.testing.assert_close(emu, fe.forest_eval_pred_plain(
        p, *pack.matmul_operands()[2:], tree_chunk=pack.tree_chunk),
        atol=0, rtol=0)
    np.testing.assert_allclose(emu.numpy(), want, **TOL)


def _shaped(kind, n_trees, n_leaves, n_features, seed):
    """A port ensemble of chain or heap-shaped trees (node i splits into
    2i+1 and 2i+2), with one one-leaf tree between them for "lone"."""
    rng = np.random.default_rng(seed)
    if kind == "chain":
        ref = g._synthetic_ensemble(n_trees=n_trees, n_leaves=n_leaves,
                                    n_features=n_features, rng=rng)
        return from_reference_arrays(ref.trees, ref.weights)
    ens = E.TreeEnsemble()
    M = 2 * n_leaves - 1
    for i in range(n_trees):
        if kind == "lone" and i == n_trees // 2:
            ens.add(E.Tree([0], [0.0], [-1], [-1], [True], [0.75]), 0.5)
        left = np.full(M, -1, np.int32)
        right = np.full(M, -1, np.int32)
        is_leaf = np.ones(M, bool)
        for n in range(n_leaves - 1):
            left[n], right[n], is_leaf[n] = 2 * n + 1, 2 * n + 2, False
        ens.add(E.Tree(rng.integers(0, n_features, M).astype(np.int32),
                       rng.normal(size=M).astype(np.float32), left, right,
                       is_leaf, rng.normal(size=M).astype(np.float32)), 0.1)
    return ens


SHAPED = {"chain-10": ("chain", 30, 10, 8), "heap-10": ("heap", 30, 10, 8),
          "lone-leaf": ("lone", 9, 6, 5), "chain-150": ("chain", 4, 150, 6),
          "heap-150": ("heap", 5, 150, 6)}


@pytest.mark.parametrize("which", list(SHAPED))
def test_pack_path_lists_are_the_nonzeros_of_PmQc(which):
    """Each pack's path records hold, tree by tree and leaf by leaf, the
    rows of the leaf column's +1 P−Q entries in order, then those of its
    −1 entries in order, inside the tree's M rows; records are a multiple
    of 4 ints."""
    kind, T, L, F = SHAPED[which]
    port = _shaped(kind, T, L, F, seed=len(which))
    for pack in (port.full_pack(F, CPU), port.forest_pack(F, CPU)):
        PmQc, paths, tc = pack.PmQc, pack.pred_paths, pack.tree_chunk
        nch, TCM, TCL = PmQc.shape
        M, lv = pack.nodes_per_tree, TCL // tc
        assert M == L - 1 and paths.dtype == torch.int32
        assert paths.shape[0] == nch * tc and paths.shape[1] % 4 == 0
        longest = 0
        for c in range(nch):
            for j in range(tc):
                rec = paths[c * tc + j]
                offs = rec[:lv + 1].tolist()
                assert offs[0] == 0 and 2 * lv + 1 + offs[-1] <= rec.numel()
                for l_ in range(lv):
                    m = rec[2 * lv + 1 + offs[l_]:2 * lv + 1 + offs[l_ + 1]]
                    n_p = int(rec[lv + 1 + l_])
                    col = PmQc[c, :, j * lv + l_]
                    for rows, part in ((torch.nonzero(col > 0), m[:n_p]),
                                       (torch.nonzero(col < 0), m[n_p:])):
                        assert torch.equal(part + j * M,
                                           rows.flatten().to(torch.int32))
                    assert bool(((m >= 0) & (m < M)).all())
                    longest = max(longest, m.numel())
        # a chain's deepest leaf lists every node of its tree
        if kind == "chain":
            assert longest == M


@pytest.mark.parametrize("which", ["lone-leaf", "chain-150", "heap-150"])
def test_pred_kernel_emulation_on_long_paths_and_lone_leaves(which):
    """150-leaf chains have paths of up to 149 entries, past the packed
    byte test's 127: those leaves count per document; the emulation stays
    bit-equal to the plain version with both counts, and with every leaf
    counted per document."""
    kind, T, L, F = SHAPED[which]
    port = _shaped(kind, T, L, F, seed=len(which))
    rng = np.random.default_rng(5)
    X = torch.from_numpy(rng.normal(size=(67, F)).astype(np.float32))
    pack = port.full_pack(F, CPU)
    fid, thr = pack.fid_full.long(), pack.thr_full
    predT = (X.T.index_select(0, fid) <= thr[:, None]).to(torch.uint8)
    want = fe.forest_eval_pred_plain(predT, *pack.matmul_operands()[2:],
                                     tree_chunk=pack.tree_chunk)
    torch.testing.assert_close(want, fe.forest_eval_full(X, pack), atol=0,
                               rtol=0)
    for dt in (torch.uint8, torch.bfloat16):
        for packed_max in (127, -1):
            torch.testing.assert_close(
                _emulate(predT.to(dt), pack, packed_max), want, atol=0,
                rtol=0)


def test_wrappers_check_inputs_and_count_only_kernel_launches():
    _, port, X, predT, _ = _pred_case(5, 4, 6, 40, seed=1)
    pack = port.forest_pack(6, CPU)
    Xt = torch.from_numpy(X)
    p = _t(predT.astype(jnp.float32)).to(torch.uint8)
    before = (fe.device_bins_narrow.launches, fe.forest_eval_pred.launches,
              fe.forest_eval_frombins.launches)
    fe.forest_eval_bins_split(Xt, pack)
    fe.forest_eval_pred(p, pack)
    assert (fe.device_bins_narrow.launches, fe.forest_eval_pred.launches,
            fe.forest_eval_frombins.launches) == before   # CPU: plain
    bad = [
        lambda: fe.device_bins_narrow(Xt.double(), pack),
        lambda: fe.device_bins_narrow(Xt[:, :5].contiguous(), pack),
        lambda: fe.device_bins_narrow(Xt.to("meta"), pack),
        lambda: fe.forest_eval_pred(p.to(torch.int32), pack),
        lambda: fe.forest_eval_pred(p[1:], pack),
        lambda: fe.forest_eval_pred(
            p, replace(pack, PmQc=pack.PmQc.double())),
        lambda: fe.forest_eval_pred(p, replace(pack, tree_chunk=7)),
        lambda: fe.forest_eval_pred(p, replace(pack, nodes_per_tree=1000)),
        lambda: fe.forest_eval_pred(
            p, replace(pack, pred_paths=pack.pred_paths.long())),
        lambda: fe.forest_eval_pred(
            p, replace(pack, pred_paths=pack.pred_paths[1:])),
        lambda: fe.forest_eval_pred(
            p, replace(pack, pred_paths=pack.pred_paths[:, :-1])),
        lambda: fe.forest_eval_pred(p.to("meta"), pack),
    ]
    for call in bad:
        with pytest.raises(RankLibError):
            call()


def test_pred_wrapper_takes_the_block_size_from_the_pack():
    """The kernel reads each tree's [M, L] block of P−Q with M taken from
    the pack that laid P−Q out. A pack whose M is below the one its rows
    were laid out with still fits a chunk but would read the wrong block
    for every tree after the first (the plain version ignores M), so the
    wrapper refuses it."""
    _, port, _, predT, _ = _pred_case(5, 4, 6, 40, seed=2)
    for pack in (port.full_pack(6, CPU), port.forest_pack(6, CPU)):
        p = _t(predT.astype(jnp.float32)).to(torch.uint8)
        want = fe.forest_eval_pred_plain(
            p, *pack.matmul_operands()[2:], tree_chunk=pack.tree_chunk)
        torch.testing.assert_close(fe.forest_eval_pred(p, pack), want,
                                   atol=0, rtol=0)
        assert pack.tree_chunk > 1 and pack.nodes_per_tree > 2
        for m in (1, pack.nodes_per_tree // 2, pack.nodes_per_tree - 1):
            with pytest.raises(RankLibError, match="do not tile"):
                fe.forest_eval_pred(p, replace(pack, nodes_per_tree=m))
