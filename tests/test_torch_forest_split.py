"""The port's split bin-space route and predicate epilogue
(ranklib_tpu_torch.ops.forest_eval) against the reference.

* Split route (``device_bins_narrow`` then ``forest_eval_frombins``, what
  ``RANKLIB_TPU_SERVE_SPLIT=1`` serves): the plain route on the CPU against
  the reference's ``forest_eval_pallas_bins_split`` in TPU-interpret mode
  and against its ``_mm_eval`` scan, on documents that sit on thresholds,
  NaN and ±inf features, and a 256-threshold grid whose ids need int16.
* ``eval_matrix`` and the CLI under the flag: the same scores as the
  default route.
* Predicate epilogue (``forest_eval_pred``): the plain version against the
  reference's ``forest_eval_pallas`` in interpret mode with bf16 node tests,
  as tests/test_forest_eval.py:44-53 drives it, and a Python emulation of
  the CUDA kernel's block-diagonal loop, bit for bit.

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


def _emulate_pred_kernel(predT, PmQc, csQc, plenc, outwc, tree_chunk, M):
    """What csrc/forest_eval.cu pred_epilogue_kernel computes, in torch:
    each tree reads only its own [M, L] block of P−Q, skips its zeros,
    takes the output of the leaf with hits == plen − csQ; trees add in
    order into one partial a chunk, chunks in order."""
    nch, TCM, TCL = PmQc.shape
    L = TCL // tree_chunk
    pred = predT.to(torch.float32)
    N = pred.shape[1]
    score = torch.zeros(N)
    for c in range(nch):
        partial = torch.zeros(N)
        for j in range(tree_chunk):
            leaf = torch.zeros(N)
            for l_ in range(L):
                col = j * L + l_
                hits = torch.zeros(N)
                for m in range(M):
                    r = j * M + m
                    w = PmQc[c, r, col]
                    if w != 0:
                        hits = hits + w * pred[c * TCM + r]
                hit = hits == plenc[c, col] - csQc[c, col]
                leaf = torch.where(hit, leaf + outwc[c, col], leaf)
            partial = partial + leaf
        score = score + partial
    return score


def test_pred_kernel_loop_over_diagonal_blocks_equals_plain_bitwise():
    _, port, X, predT, ops = _pred_case(23, 7, 13, 257, seed=11)
    pack = port.full_pack(13, CPU)
    p = _t(predT.astype(jnp.float32)).to(torch.uint8)
    ops = tuple(map(_t, ops))
    plain = fe.forest_eval_pred_plain(p, *ops, tree_chunk=pack.tree_chunk)
    emu = _emulate_pred_kernel(p, *ops, pack.tree_chunk, pack.nodes_per_tree)
    torch.testing.assert_close(emu, plain, atol=0, rtol=0)


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
