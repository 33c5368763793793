"""The port's ``-dp`` (``parallel.dist``, ``gbdt.boost_dist``) on the CPU:
gloo ranks, one spawned process a rank, against the single-device fit and
the reference's mesh fit (tests/test_parallel.py).

* The first tree equals the single-device tree in structure and
  thresholds, leaf outputs to rtol 1e-5; metrics within the reference's
  0.03 of both fits (a near-tie may flip: sums run in another order).
* Every rank ends with the same model text (the summed statistics carry
  the same bits on every rank); the fit checks it and the tests see it.
* The ranks run one thread each; the single-device fits here run the
  process's default, and the trees agree regardless.

The reference is imported inside the tests: this module is also what a
spawned rank imports to find :func:`_raise_on_rank1`.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from ranklib_tpu_torch.cli import main as port_main
from ranklib_tpu_torch.data.letor import read_letor
from ranklib_tpu_torch.gbdt.ensemble import TreeEnsemble
from ranklib_tpu_torch.gbdt.boost_dist import build_sharded_data
from ranklib_tpu_torch.metrics.base import create_scorer, score_dataset
from ranklib_tpu_torch.models import gbdt as PG
from ranklib_tpu_torch.models.gbdt import LambdaMART
from ranklib_tpu_torch.models.rf import RFRanker
from ranklib_tpu_torch.parallel import dist
from ranklib_tpu_torch.utils.errors import RankLibError
from ranklib_tpu_torch.utils.logging import set_silent

CPU = torch.device("cpu")
TREE_FIELDS = ("feature", "threshold", "left", "right", "is_leaf")


@pytest.fixture(autouse=True)
def _port_defaults(monkeypatch):
    monkeypatch.setenv("RANKLIB_TPU_TORCH_DEVICE", "cpu")
    set_silent(False)
    yield
    set_silent(False)


@pytest.fixture
def rank_models(monkeypatch):
    """Every rank's ensembles of each fit, as the fit checks them."""
    seen = []
    check = PG.check_same_models

    def keep(ensembles):
        seen.append([e.to_text() for e in ensembles])
        check(ensembles)

    monkeypatch.setattr(PG, "check_same_models", keep)
    import ranklib_tpu_torch.models.rf as PRF
    monkeypatch.setattr(PRF, "check_same_models", keep)
    return seen


def _files(tmp_path, n=32):
    from tests.fixtures import synth_dataset, write_letor_text

    paths = {}
    for name, nq, seed in (("train", n, 9), ("vali", 16, 10)):
        paths[name] = str(tmp_path / f"{name}.txt")
        write_letor_text(synth_dataset(n_queries=nq, n_features=6,
                                       min_docs=8, max_docs=24, seed=seed,
                                       w_seed=4, signal=3.0), paths[name])
    return paths


def _metric(ranker, ds, scorer):
    return score_dataset(scorer, ds, ranker.eval_dataset(ds, CPU), CPU)[0]


def _kernels(counts: dict) -> dict:
    """A rank's launch counts without its collectives."""
    return {k: v for k, v in counts.items() if not k.startswith("all_reduce")}


def _same_tree(a, b):
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)
    np.testing.assert_allclose(b.output, a.output, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [2, 3])
def test_mesh_fit_matches_single_device(tmp_path, rank_models, n):
    """tests/test_parallel.py:37-75 and :100-122 at 2 and 3 ranks: the first
    tree is the single-device tree; the metric is within 0.03 of the
    single-device fit's and of the reference's make_mesh(n) fit; all
    ranks' models are equal."""
    from ranklib_tpu.data.letor import read_letor as ref_read
    from ranklib_tpu.metrics.base import create_scorer as ref_scorer
    from ranklib_tpu.models.gbdt import LambdaMART as RefLambdaMART
    from ranklib_tpu.parallel.dist import make_mesh as ref_mesh

    paths = _files(tmp_path)
    train = read_letor(paths["train"])
    scorer = create_scorer("NDCG@10")
    hp = dict(n_trees=5, n_leaves=4, learning_rate=0.2)
    single = LambdaMART(**hp)
    single.fit(train, scorer, device=CPU)
    mesh = LambdaMART(**hp)
    mesh.fit(train, scorer, device=CPU, mesh=dist.make_mesh(n, CPU))
    assert len(mesh.ensemble) == 5 and mesh.fit_state is None
    # each rank's kernel launches (none on the CPU: the plain versions),
    # and its collectives, the same on every rank: 8 a round (the root's
    # histogram and sum, a histogram and a sum for each of the 2 splits
    # that build children, the leaf sums, the train metric): three
    # [F, B, 2] f32 histograms, four f32 scalars, the [2, 7] f32 leaf sums
    assert [_kernels(c) for c in mesh.rank_launches] == [
        _kernels(PG.launch_counts())] * n
    assert set(mesh.rank_launches[0]) >= {"histogram", "split_scan"}
    hist = 6 * PG.flatten_binned(train, 256)[3].shape[1] * 2 * 4
    assert {c["all_reduce"] for c in mesh.rank_launches} == {8 * 5}
    assert {c["all_reduce_bytes"] for c in mesh.rank_launches} == {
        5 * (3 * hist + 4 * 4 + 2 * 7 * 4)}
    _same_tree(single.ensemble.trees[0], mesh.ensemble.trees[0])
    assert len(rank_models) == 1 and len(rank_models[0]) == n
    assert len(set(rank_models[0])) == 1
    assert rank_models[0][0] == mesh.ensemble.to_text()
    rtrain = ref_read(paths["train"], quiet=True)
    ref = RefLambdaMART(**hp)
    ref.fit(rtrain, ref_scorer("NDCG@10"), mesh=ref_mesh(n))
    m_ref = ref.score_metric(rtrain, ref_scorer("NDCG@10"))
    m_mesh = _metric(mesh, train, scorer)
    assert abs(m_mesh - _metric(single, train, scorer)) < 0.03
    assert abs(m_mesh - m_ref) < 0.03
    assert m_mesh > 0.8


def _rounds_rank(rank, device, group, ranker, train, binned, thresholds,
                 validation, vbinned, feature_mask, scorer, init, vinit):
    """One rank: ``fit_shard``'s round loop, then the step that
    ``prepare_shard`` returns driven round by round; each one's records
    (model text of every round's tree, validation metrics)."""
    import copy

    n = ranker.n_trees
    b, vb = binned.numpy(), vbinned.numpy()

    def records(state):
        return (PG._export(state, n, thresholds,
                           ranker.learning_rate).to_text(),
                state.val_m[:n].tolist())

    looped = copy.copy(ranker)
    looped.fit_shard(rank, device, group, train, b, thresholds, scorer,
                     validation, vb, feature_mask, init, vinit)
    step, state, data = ranker.prepare_shard(
        rank, device, group, train, b, thresholds, scorer, validation, vb,
        feature_mask, init, vinit)
    for t in range(n):
        state = step(state, t, data)
    return records(looped.fit_state), records(state)


def test_prepare_shard_rounds_equal_fit_shard(tmp_path):
    """Two ranks driving ``prepare_shard``'s step round by round (as the
    benchmark does) record the trees and validation metrics of
    ``fit_shard``'s loop, bit for bit on both ranks, and the one-process
    fit's: every tree in structure and thresholds (leaf outputs to rtol
    1e-5), the validation metrics to 1e-5."""
    paths = _files(tmp_path)
    train = read_letor(paths["train"])
    vali = read_letor(paths["vali"], n_features=train.n_features)
    scorer = create_scorer("NDCG@10")
    hp = dict(n_trees=5, n_leaves=4, learning_rate=0.2)
    mesh = dist.make_mesh(2, CPU)
    set_silent(True)
    out = dist.run(mesh, _rounds_rank, *LambdaMART(**hp).rank_args(
        train, scorer, vali, CPU, mesh))
    (looped, stepped), (looped1, stepped1) = out
    assert looped == stepped == looped1 == stepped1
    single = LambdaMART(**hp)
    single.fit(train, scorer, vali, device=CPU)
    want = TreeEnsemble.from_text(PG._export(
        single.fit_state, 5, PG.flatten_binned(train, 256)[3],
        0.2).to_text())
    got = TreeEnsemble.from_text(stepped[0])
    assert len(got.trees) == 5
    for a, b in zip(want.trees, got.trees):
        _same_tree(a, b)
    np.testing.assert_allclose(stepped[1],
                               single.fit_state.val_m[:5].numpy(),
                               atol=1e-5)


def _collective_rank(rank, device, group):
    """``sum_across`` of an f32 [3, 4], a 0-d f32 and an int64 [5] under
    ``group`` (the last through a wrapper standing in for the module's
    name, as a profiler's does) and of one tensor without: the counters'
    growth and the sums."""
    from ranklib_tpu_torch.gbdt import grow
    from ranklib_tpu_torch.gbdt.grow import sum_across

    before = PG.launch_counts()
    x = sum_across(torch.ones(3, 4), group)
    y = sum_across(torch.tensor(2.0), group)
    grow.sum_across = lambda t, g: sum_across(t, g)
    try:
        z = grow.sum_across(torch.arange(5), group)
    finally:
        grow.sum_across = sum_across
    sum_across(torch.ones(7), None)
    got = PG.launches_since(before)
    return (got["all_reduce"], got["all_reduce_bytes"], _kernels(got),
            x.tolist(), float(y), z.tolist())


def test_sum_across_counts_each_collective_once():
    """Each collective counts once, with the bytes it reduced (48 + 4 +
    40), on every rank; a call without a group counts nothing, in a rank
    and in this process."""
    from ranklib_tpu_torch.gbdt.grow import sum_across

    got = dist.run(dist.make_mesh(2, CPU), _collective_rank)
    zeros = _kernels({k: 0 for k in PG.launch_counts()})
    assert got == [(3, 92, zeros, [[2.0] * 4] * 3, 4.0,
                    [0, 2, 4, 6, 8])] * 2
    before = PG.launch_counts()
    sum_across(torch.ones(7), None)
    assert PG.launch_counts() == before


def test_mesh_early_stop_with_validation(tmp_path):
    """tests/test_parallel.py:125-137: early stop and best-round rollback
    on the mesh; the validation metric within 0.03 of the single-device
    fit's."""
    paths = _files(tmp_path)
    train, vali = read_letor(paths["train"]), read_letor(paths["vali"])
    scorer = create_scorer("NDCG@10")
    hp = dict(n_trees=10, n_leaves=4, learning_rate=0.3, early_stop=3)
    single = LambdaMART(**hp)
    single.fit(train, scorer, vali, device=CPU)
    mesh = LambdaMART(**hp)
    mesh.fit(train, scorer, vali, device=CPU, mesh=dist.make_mesh(2, CPU))
    assert 1 <= len(mesh.ensemble) <= 10
    m = _metric(mesh, vali, scorer)
    assert m > 0.7
    assert abs(m - _metric(single, vali, scorer)) < 0.03


def test_mesh_warm_start_resume(tmp_path, rank_models):
    """tests/test_parallel.py:182-211: a prior ensemble seeds every
    rank's scores and only the rounds left train; the prior trees are
    carried verbatim; within 0.05 of a straight 4-tree fit."""
    paths = _files(tmp_path, n=24)
    train = read_letor(paths["train"])
    scorer = create_scorer("NDCG@10")
    part = LambdaMART(n_trees=2, n_leaves=4, learning_rate=0.2)
    part.fit(train, scorer, device=CPU)
    resumed = LambdaMART(n_trees=4, n_leaves=4, learning_rate=0.2)
    resumed.ensemble = part.ensemble
    resumed.fit(train, scorer, device=CPU, mesh=dist.make_mesh(2, CPU))
    assert len(resumed.ensemble) == 4
    assert (resumed.ensemble.to_text().split("</tree>")[:2]
            == part.ensemble.to_text().split("</tree>")[:2])
    assert all(len(set(r)) == 1 for r in rank_models)
    full = LambdaMART(n_trees=4, n_leaves=4, learning_rate=0.2)
    full.fit(train, scorer, device=CPU)
    assert abs(_metric(full, train, scorer)
               - _metric(resumed, train, scorer)) < 0.05


def test_cli_dp_ckpt_eventlog_profile(tmp_path, capsys):
    """-dp 2 with -ckpt, -eventlog and -profile through the CLI: rank 0
    prints the table once, writes the 4 "round" records and the
    checkpoint (the saved model's bytes, no validation); every rank
    writes its trace beside the parent's."""
    paths = _files(tmp_path)
    m, ev, prof = (str(tmp_path / "m.txt"), str(tmp_path / "ev.jsonl"),
                   str(tmp_path / "prof"))
    assert port_main(["-train", paths["train"], "-ranker", "6", "-tree",
                      "4", "-leaf", "4", "-metric2t", "NDCG@10", "-dp", "2",
                      "-ckpt", "2", "-eventlog", ev, "-profile", prof,
                      "-save", m]) == 0
    out = capsys.readouterr().out
    assert "Training starts... [data-parallel over 2 devices]" in out
    assert out.count("#iter") == 1
    assert open(m + ".ckpt").read() == open(m).read()
    recs = [json.loads(ln) for ln in open(ev)]
    assert [r["round"] for r in recs] == [1, 2, 3, 4]
    table = [ln.split("|") for ln in out.splitlines()
             if ln[:1].isdigit() and "|" in ln]
    assert [f"{r['train_metric']:.4f}" for r in recs] == [
        t[1].strip() for t in table]
    names = sorted(os.path.basename(p).split(".")[0]
                   for p in glob.glob(os.path.join(prof, "*.pt.trace.json")))
    assert names[:2] == ["rank0", "rank1"] and len(names) == 3


@pytest.mark.parametrize("rtype", [0, 6])
def test_rf_mesh_matches_reference(tmp_path, rank_models, rtype):
    """Random Forests -rtype 0 and 6 under -dp 2 (ref _fit_bags_rebuild):
    the metric within 0.03 of the single-device forest's; every rank's
    bags equal; -rtype 0's bags are the reference's make_mesh(2) bags
    (-rtype 6's bags are LambdaMART -dp fits, held to the reference
    above)."""
    from ranklib_tpu.data.letor import read_letor as ref_read
    from ranklib_tpu.metrics.base import create_scorer as ref_scorer
    from ranklib_tpu.models.rf import RFRanker as RefRF
    from ranklib_tpu.parallel.dist import make_mesh as ref_mesh

    paths = _files(tmp_path, n=16)
    train = read_letor(paths["train"])
    scorer = create_scorer("NDCG@10")
    hp = dict(n_bags=3, n_trees=2, n_leaves=3, ranker_type=rtype)
    mesh = RFRanker(**hp)
    mesh.fit(train, scorer, device=CPU, mesh=dist.make_mesh(2, CPU))
    assert len(rank_models) == 3 and all(len(set(r)) == 1
                                         for r in rank_models)
    assert [_kernels(c) for c in mesh.rank_launches] == [
        _kernels(PG.launch_counts())] * 2
    assert mesh.rank_launches[0]["all_reduce"] == \
        mesh.rank_launches[1]["all_reduce"] > 0
    if rtype == 0:
        ref = RefRF(**hp)
        ref.fit(ref_read(paths["train"], quiet=True), ref_scorer("NDCG@10"),
                mesh=ref_mesh(2))
        for a, b in zip(ref.ensembles, mesh.ensembles):
            assert len(a.trees) == len(b.trees) == 2
            for ta, tb in zip(a.trees, b.trees):
                _same_tree(ta, tb)
    single = RFRanker(**hp)
    single.fit(train, scorer, device=CPU)
    assert abs(_metric(mesh, train, scorer)
               - _metric(single, train, scorer)) < 0.03


@pytest.mark.parametrize("ranker", ["6", "8"])
def test_sparse_dp_equals_dense_dp(tmp_path, ranker):
    """tests/test_parallel.py:413-446: -sparse -dp 2 (the streamed bin
    matrix sharded) saves the dense -dp 2 fit's model bytes, for
    LambdaMART and Random Forests."""
    paths = _files(tmp_path, n=16)
    models = []
    for extra in ([], ["-sparse"]):
        m = str(tmp_path / f"m{len(models)}.txt")
        assert port_main(["-train", paths["train"], "-ranker", ranker,
                          "-tree", "3", "-leaf", "3", "-bag", "2",
                          "-metric2t", "NDCG@10", "-dp", "2", "-validate",
                          paths["vali"], "-save", m, *extra]) == 0
        models.append(open(m).read())
    assert models[1] == models[0]


def test_validation_bin_256_does_not_wrap():
    """tests/test_parallel.py:504: the shards' id type covers the
    validation bins; a validation id of 256 next to training ids of at
    most 255 survives on its rank (uint8 would wrap it to 0)."""
    from tests.fixtures import synth_dataset

    train = synth_dataset(n_queries=8, n_features=4, min_docs=5,
                          max_docs=9, seed=3)
    val = synth_dataset(n_queries=4, n_features=4, min_docs=5, max_docs=9,
                        seed=4, w_seed=3)
    Nt, Nv = train.n_docs, val.n_docs
    rng = np.random.default_rng(0)
    binned = rng.integers(0, 256, size=(Nt, 4)).astype(np.int32)
    binned[0] = 255
    vbinned = rng.integers(0, 256, size=(Nv, 4)).astype(np.int32)
    vbinned[0] = 256
    tops = []
    for rank in range(2):
        data, *_ = build_sharded_data(train, binned, 2, rank, CPU,
                                      validation=val, vbinned=vbinned)
        tops.append(int(data.vbinned.max()))
    assert max(tops) == 256


def _raise_on_rank1(rank, device, group):
    if rank == 1:
        raise ValueError("boom on rank 1")
    torch.distributed.all_reduce(torch.zeros(1), group=group)   # waits


def test_a_raising_rank_fails_the_fit():
    """The rank's error and traceback fail the run; the peer waiting in
    its collective is stopped, not waited for."""
    with pytest.raises(RankLibError) as e:
        dist.run(dist.make_mesh(2, CPU), _raise_on_rank1)
    assert "rank 1 of the 2-rank -dp mesh failed" in str(e.value)
    assert "ValueError: boom on rank 1" in str(e.value)
    assert "_raise_on_rank1" in str(e.value)        # the traceback


def test_dp_with_another_ranker_exits_1(tmp_path, capsys):
    """-dp reaches every ranker: with Coordinate Ascent, -dp 2 through the
    CLI exits as the reference's does (0) and prints its result lines (the
    weights within 1e-6 of its make_mesh(2) fit's)."""
    from ranklib_tpu.cli import main as ref_main

    paths = _files(tmp_path, n=16)
    argv = ["-train", paths["train"], "-ranker", "4", "-r", "2", "-i", "5",
            "-metric2t", "NDCG@10", "-validate", paths["vali"], "-dp", "2"]
    lines = {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        assert main(argv) == 0
        lines[name] = [ln for ln in capsys.readouterr().out.splitlines()
                       if " on " in ln and "data:" in ln]
    assert lines["port"] == lines["ref"] and len(lines["port"]) == 4


# per ranker: a small fit's hyperparameters
_SMALL = {0: dict(n_trees=2, n_leaves=3), 1: dict(n_epoch=1),
          2: dict(n_rounds=5), 3: dict(n_rounds=5),
          4: dict(n_restart=1, max_passes=1, n_max_iteration=3),
          5: dict(n_epoch=1), 6: dict(n_trees=2, n_leaves=3),
          7: dict(n_epoch=1), 8: dict(n_bags=2, n_trees=1, n_leaves=3),
          9: {}}


@pytest.mark.parametrize("ranker", range(10))
def test_dp_refusal_is_one_decision(tmp_path, capsys, ranker):
    """Which rankers take -dp is one decision, the trainer's: every ranker
    whose fit takes a mesh fits on it (one launch-count record a rank),
    and Linear Regression, whose fit takes none, logs the reference's line
    and fits on one device."""
    from ranklib_tpu_torch.models.trainer import train_ranker

    train = read_letor(_files(tmp_path, n=4)["train"])
    capsys.readouterr()
    r = train_ranker(ranker, train, create_scorer("NDCG@10"), None,
                     _SMALL[ranker], CPU, n_dp=2)
    out = capsys.readouterr().out
    ignored = "(Linear Regression has no data-parallel path; -dp ignored)"
    if ranker == 9:
        assert out.splitlines()[0] == ignored
        assert getattr(r, "rank_launches", None) is None
        return
    assert ignored.split()[-2] not in out
    assert len(r.rank_launches) == 2
