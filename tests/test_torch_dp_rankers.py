"""``-dp`` for the rankers that are not trees (``parallel.dp``) on the CPU:
gloo ranks, one spawned process a rank, against the reference's
``make_mesh(n)`` fits on its own fixture (tests/test_parallel.py:240-501)
and to its own bounds:

* RankBoost and AdaRank: the same weak sequence, α within 1e-5;
* Coordinate Ascent: weights within 1e-6 dense, 2e-4 on the COO route;
* RankNet, LambdaRank, ListNet: from the reference's initial draws, the
  parameters within the nets' parity tolerance (5e-5) of the reference's
  synchronous minibatch fit;
* every rank ends with the same model (the fit checks it, the tests see
  it); ``-dp 3`` leaves padded lockstep rows and slots on the fixture.

The sharders are held against the reference's in-process, rank by rank:
the same deal, slots, padding and COO entries. A test starts at most one
process group; several fits share one through ``parallel.dp.run_jobs``.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from ranklib_tpu.cli import main as ref_main
from ranklib_tpu.metrics.base import create_scorer as ref_scorer
from ranklib_tpu.models import neural as RN
from ranklib_tpu.parallel.dist import make_mesh as ref_mesh
from ranklib_tpu_torch.cli import main as port_main
from ranklib_tpu_torch.data.dataset import Dataset, Query
from ranklib_tpu_torch.data.sparse import read_letor_sparse
from ranklib_tpu_torch.metrics.base import create_scorer
from ranklib_tpu_torch.models import neural as PN
from ranklib_tpu_torch.models.adarank import AdaRank
from ranklib_tpu_torch.models.coorascent import CoorAscent
from ranklib_tpu_torch.models.rankboost import RankBoost
from ranklib_tpu_torch.parallel import dist
from ranklib_tpu_torch.parallel import dp as PDP
from ranklib_tpu_torch.utils.logging import set_silent
from tests.fixtures import synth_dataset, write_letor_text

CPU = torch.device("cpu")
NETS = {"RankNet": (RN.RankNet, PN.RankNet),
        "LambdaRank": (RN.LambdaRank, PN.LambdaRank),
        "ListNet": (RN.ListNet, PN.ListNet)}


@pytest.fixture(autouse=True)
def _port_defaults(monkeypatch):
    """The CPU, and the reference's initial draws for the nets (drawn in
    the parent, which sends them to the ranks)."""
    monkeypatch.setenv("RANKLIB_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(PN, "_init_params", lambda gen, sizes: [
        (np.asarray(W), np.asarray(b)) for W, b in RN._init_params(
            jax.random.PRNGKey(gen.initial_seed()), sizes)])
    set_silent(False)
    yield
    set_silent(False)


@pytest.fixture
def rank_models(monkeypatch):
    """Every rank's model text of each mesh fit, as the fit checks it."""
    seen = []
    check = PDP.check_same_rankers

    def keep(rankers):
        seen.append([r.model_str() for r in rankers])
        check(rankers)

    monkeypatch.setattr(PDP, "check_same_rankers", keep)
    return seen


def _fixture():
    """The reference's ``_dp_fixture`` (tests/test_parallel.py:240)."""
    train = synth_dataset(n_queries=24, n_features=10, min_docs=5,
                          max_docs=30, seed=5, nonlinear=True)
    val = synth_dataset(n_queries=8, n_features=10, min_docs=5,
                        max_docs=30, seed=6, w_seed=5, nonlinear=True)
    return train, val


def _port(ds):
    if ds is None:
        return None
    return Dataset([Query(q.qid, q.labels.copy(), q.feats.copy())
                    for q in ds.queries], ds.n_features)


def _files(tmp_path, ds, val=None):
    paths = [str(tmp_path / "train.txt")]
    write_letor_text(ds, paths[0])
    if val is not None:
        paths.append(str(tmp_path / "vali.txt"))
        write_letor_text(val, paths[1])
    return paths


def _same_weaks(got, want, alpha_tol=1e-5):
    """RankBoost's (fid, θ, α) or AdaRank's (fid, α) records: all but α
    equal, α within ``alpha_tol``."""
    assert len(got) == len(want) > 0
    assert [w[:-1] for w in got] == [w[:-1] for w in want]
    assert max(abs(a[-1] - b[-1]) for a, b in zip(got, want)) < alpha_tol


def _all_equal(rank_models, n_fits, n):
    assert len(rank_models) == n_fits
    assert all(len(r) == n and len(set(r)) == 1 for r in rank_models)


# ---- the sharders against the reference's ---------------------------------

def _datasets(kind, tmp_path):
    train, _ = _fixture()
    if kind == "dense":
        return _port(train), train
    from ranklib_tpu.data.sparse import read_letor_sparse as ref_sparse

    p = _files(tmp_path, train)[0]
    return read_letor_sparse(p, quiet=True), ref_sparse(p, quiet=True)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("kind", ["dense", "csr"])
def test_feat_buckets_match_reference(tmp_path, kind, n):
    """Each rank's buckets are the reference's ``[rank]`` slices: the same
    deal and slots, every class with the same rows on every rank, padded
    rows all-False with the Qpad slot; under a doc budget, the same
    chunks."""
    from ranklib_tpu.parallel.dp import shard_feat_buckets as ref_shard

    ds, rds = _datasets(kind, tmp_path)
    for budget in (None, 64):
        want, rQpad, rper = ref_shard(rds, n, ref_mesh(n), want_qidx=True,
                                      doc_budget=budget)
        for rank in range(n):
            got, Qpad, per_dev = PDP.shard_feat_buckets(
                ds, n, rank, CPU, want_qidx=True, doc_budget=budget)
            assert Qpad == rQpad and per_dev == rper
            assert len(got) == len(want)
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a.numpy(),
                                                  np.asarray(b)[rank])


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("kind", ["dense", "csr"])
def test_sparse_data_matches_reference(tmp_path, kind, n):
    """Each rank's COO entries (fid, value, local row) and metric buckets
    are the reference's ``[rank]`` slices: the same deal, slots, Npad and
    Qpad sentinels."""
    from ranklib_tpu.parallel.dp import shard_sparse_data as ref_shard

    ds, rds = _datasets(kind, tmp_path)
    rchunks, rbks, rQpad, rNpad, rper = ref_shard(rds, n, ref_mesh(n))
    for rank in range(n):
        chunks, bks, Qpad, Npad, per_dev = PDP.shard_sparse_data(
            ds, n, rank, CPU)
        assert (Qpad, Npad, per_dev) == (rQpad, rNpad, rper)
        rf, rv, rr = (np.concatenate([np.asarray(c[i])[rank]
                                      for c in rchunks]) for i in range(3))
        real = rr != rNpad
        f, v, rid, run = (torch.cat([c[i] for c in chunks]).numpy()
                          for i in range(4))
        np.testing.assert_array_equal(f, rf[real])
        np.testing.assert_array_equal(v, rv[real])
        np.testing.assert_array_equal(np.repeat(rid, run), rr[real])
        assert len(bks) == len(rbks)
        for g, w in zip(bks, rbks):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b)[rank])


# ---- the rankers against the reference's mesh fits -------------------------

@pytest.mark.parametrize("n", [2, 3])
def test_rankboost_mesh_matches_reference(rank_models, n):
    """tests/test_parallel.py:250-265 at -dp 2 and 3, with validation."""
    from ranklib_tpu.models.rankboost import RankBoost as RefRB

    train, val = _fixture()
    ref = RefRB(n_rounds=30)
    ref.fit(train, ref_scorer("NDCG@10"), val, mesh=ref_mesh(n))
    port = RankBoost(n_rounds=30)
    port.fit(_port(train), create_scorer("NDCG@10"), _port(val), device=CPU,
             mesh=dist.make_mesh(n, CPU))
    _same_weaks(port.weaks, ref.weaks)
    _all_equal(rank_models, 1, n)
    # no kernel on the CPU; the same collectives on every rank
    assert all(v == 0 for c in port.rank_launches for k, v in c.items()
               if not k.startswith("all_reduce"))
    assert len({(c["all_reduce"], c["all_reduce_bytes"])
                for c in port.rank_launches}) == 1
    assert port.rank_launches[0]["all_reduce"] > 0


@pytest.mark.parametrize("n", [2, 3])
def test_adarank_mesh_matches_reference(rank_models, n):
    """tests/test_parallel.py:268-280 at -dp 2 and 3, without validation
    (every kept round compared) and with it (the same cut), in one
    process group."""
    from ranklib_tpu.models.adarank import AdaRank as RefAda

    train, val = _fixture()
    fits, refs = [], []
    for v in (None, val):
        ref = RefAda(n_rounds=40)
        ref.fit(train, ref_scorer("NDCG@10"), v, mesh=ref_mesh(n))
        refs.append(ref)
        fits.append((AdaRank(n_rounds=40), _port(train),
                     create_scorer("NDCG@10"), _port(v)))
    PDP.fit_many(dist.make_mesh(n, CPU), fits)
    for (port, *_), ref in zip(fits, refs):
        _same_weaks(port.history, ref.history)
        np.testing.assert_allclose(port.weights, ref.weights, atol=1e-5)
    _all_equal(rank_models, 2, n)


@pytest.mark.parametrize("n", [2, 3])
def test_coorascent_mesh_matches_reference(rank_models, n):
    """tests/test_parallel.py:341-354 at -dp 2 and 3: weights within 1e-6;
    the validation line is the reference's."""
    from ranklib_tpu.models.coorascent import CoorAscent as RefCA

    train, val = _fixture()
    ref = RefCA(n_restart=2, max_passes=3)
    ref.fit(train, ref_scorer("NDCG@10"), mesh=ref_mesh(n))
    port = CoorAscent(n_restart=2, max_passes=3)
    port.fit(_port(train), create_scorer("NDCG@10"), _port(val),
             device=CPU, mesh=dist.make_mesh(n, CPU))
    np.testing.assert_allclose(port.weights, ref.weights, atol=1e-6)
    _all_equal(rank_models, 1, n)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("name", list(NETS))
def test_nets_mesh_match_reference(rank_models, name, n):
    """tests/test_parallel.py:283-320: from the reference's draws, the
    -dp n fit (a synchronous minibatch of n queries a step, gradients
    summed) is the reference's make_mesh(n) fit, validation snapshot
    included."""
    train, val = _fixture()
    hp = dict(n_epoch=3, learning_rate=0.01 if name == "ListNet" else 0.001)
    ref_cls, port_cls = NETS[name]
    ref = ref_cls(**hp)
    ref.fit(train, ref_scorer("NDCG@10"), val, mesh=ref_mesh(n))
    port = port_cls(**hp)
    port.fit(_port(train), create_scorer("NDCG@10"), _port(val), device=CPU,
             mesh=dist.make_mesh(n, CPU))
    for (Wp, bp), (Wr, br) in zip(port.params, ref.params):
        np.testing.assert_allclose(Wp, np.asarray(Wr), atol=5e-5)
        np.testing.assert_allclose(bp, np.asarray(br), atol=5e-5)
    _all_equal(rank_models, 1, n)


@pytest.mark.parametrize("ranker", ["adarank", "coorascent"])
def test_coo_route_matches_reference(tmp_path, monkeypatch, rank_models,
                                     ranker):
    """tests/test_parallel.py:449-501 at -dp 3: the COO route
    (RANKLIB_TPU_DEVICE_DENSE_MB=0) with a sharded dense validation set,
    against the reference's COO mesh fit: AdaRank's sequence and α within
    1e-5, CA's weights within 2e-4."""
    from ranklib_tpu.data.sparse import read_letor_sparse as ref_sparse
    from ranklib_tpu.models.adarank import AdaRank as RefAda
    from ranklib_tpu.models.coorascent import CoorAscent as RefCA
    from ranklib_tpu_torch.ops.sparse_eval import wants_sparse_eval

    train, val = _fixture()
    p = _files(tmp_path, train)[0]
    monkeypatch.setenv("RANKLIB_TPU_DEVICE_DENSE_MB", "0")
    csr = read_letor_sparse(p, quiet=True)
    assert wants_sparse_eval(csr)
    if ranker == "adarank":
        ref, port = RefAda(n_rounds=20), AdaRank(n_rounds=20)
    else:
        ref = RefCA(n_restart=2, max_passes=3)
        port = CoorAscent(n_restart=2, max_passes=3)
    ref.fit(ref_sparse(p, quiet=True), ref_scorer("NDCG@10"), val,
            mesh=ref_mesh(3))
    port.fit(csr, create_scorer("NDCG@10"), _port(val), device=CPU,
             mesh=dist.make_mesh(3, CPU))
    if ranker == "adarank":
        _same_weaks(port.history, ref.history)
    else:
        np.testing.assert_allclose(port.weights, ref.weights, atol=2e-4)
    _all_equal(rank_models, 1, 3)


def test_csr_train_under_mesh_equals_dense(tmp_path, rank_models):
    """tests/test_parallel.py:300-320 and :357-410 in one process group of
    2 ranks: narrow -sparse (CSR) training data gives the dense file's
    fits, RankBoost's weak rankers and RankNet's parameters bit for bit;
    a second RankNet fit on the dense data ends with the same parameters
    (the two-rank fit is deterministic), above the untrained start's
    training metric."""
    from ranklib_tpu_torch.data.letor import read_letor
    from ranklib_tpu_torch.metrics.base import score_dataset

    ds = synth_dataset(n_queries=16, n_features=9, min_docs=5, max_docs=20,
                       gmax=2, seed=77)
    p = _files(tmp_path, ds)[0]
    scorer = create_scorer("NDCG@10")
    dense, csr = read_letor(p), read_letor_sparse(p, quiet=True)
    assert hasattr(csr, "materialize_rows")
    fits = [(cls(**hp), data, scorer, None)
            for cls, hp in ((RankBoost, dict(n_rounds=10)),
                            (PN.RankNet, dict(n_epoch=4,
                                              learning_rate=0.001)))
            for data in (dense, csr)]
    fits.append((PN.RankNet(n_epoch=4, learning_rate=0.001), dense, scorer,
                 None))
    PDP.fit_many(dist.make_mesh(2, CPU), fits)
    models = [r.model_str() for r, *_ in fits]
    assert len(fits[0][0].weaks) == 10
    assert models[0] == models[1]
    assert models[2] == models[3] == models[4]
    _all_equal(rank_models, 5, 2)
    base = PN.RankNet(n_epoch=0)
    base.fit(dense, scorer, device=CPU)
    metric = [score_dataset(scorer, dense, r.eval_dataset(dense, CPU),
                            CPU)[0] for r in (fits[2][0], base)]
    assert metric[0] > metric[1] - 1e-6


# ---- the CLI, the event log and the API ------------------------------------

@pytest.mark.parametrize("case", ["linear", "coo-net"])
def test_dp_ignored_lines_word_for_word(tmp_path, monkeypatch, capsys, case):
    """-dp 2 with Linear Regression, and with RankNet on the COO route
    (RANKLIB_TPU_DEVICE_DENSE_MB=0), prints the reference's '-dp ignored'
    line where the reference prints it, and the same result lines: both
    fit on one device."""
    train, val = _fixture()
    paths = _files(tmp_path, train, val)
    if case == "linear":
        extra, line = ["-ranker", "9"], (
            "(Linear Regression has no data-parallel path; -dp ignored)")
    else:
        monkeypatch.setenv("RANKLIB_TPU_DEVICE_DENSE_MB", "0")
        extra, line = ["-ranker", "1", "-sparse", "-epoch", "2"], (
            "(sparse first layer is single-device; -dp ignored)")
    argv = ["-train", paths[0], "-validate", paths[1], "-metric2t",
            "NDCG@10", "-dp", "2", *extra]
    out = {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        assert main(argv) == 0
        out[name] = capsys.readouterr().out.splitlines()
    for lines in out.values():
        assert lines.count(line) == 1
    around = {k: v[v.index(line) - 1] for k, v in out.items()}
    assert around["port"] == around["ref"]
    results = {k: [ln for ln in v if " on " in ln and "data:" in ln]
               for k, v in out.items()}
    if case == "linear":
        assert results["port"] == results["ref"]
    else:                        # other initial draws: the lines only
        assert len(results["port"]) == len(results["ref"]) == 2


@pytest.mark.parametrize("ranker", ["1", "4"])
def test_eventlog_and_profile_under_dp(tmp_path, capsys, ranker):
    """-dp 2 -eventlog -profile through the CLI with RankNet and
    Coordinate Ascent: rank 0 prints the table once and writes one
    "epoch"/"sweep" record a printed line, and every rank writes its
    trace beside the parent's."""
    import glob

    train, _ = _fixture()
    path = _files(tmp_path, train)[0]
    ev, prof = str(tmp_path / "ev.jsonl"), str(tmp_path / "prof")
    assert port_main(["-train", path, "-ranker", ranker, "-epoch", "3",
                      "-r", "1", "-i", "4", "-metric2t", "NDCG@10", "-dp",
                      "2", "-eventlog", ev, "-profile", prof]) == 0
    out = capsys.readouterr().out
    recs = [json.loads(ln) for ln in open(ev)]
    if ranker == "1":
        table = [ln.split("|") for ln in out.splitlines()
                 if ln[:1].isdigit() and "|" in ln]
        assert out.count("#epoch") == 1
        assert [r["event"] for r in recs] == ["epoch"] * 3
        assert [f"{r['misordered_pairs']:.0f}" for r in recs] == [
            t[1].strip() for t in table]
    else:
        passes = [ln for ln in out.splitlines()
                  if ln.startswith("  pass ")]
        assert [r["event"] for r in recs] == ["sweep"] * len(passes) != []
        assert [f"{r['best_metric']:.4f}" for r in recs] == [
            ln.split("= ")[1].split()[0] for ln in passes]
    names = sorted(os.path.basename(p).split(".")[0]
                   for p in glob.glob(os.path.join(prof, "*.pt.trace.json")))
    assert names[:2] == ["rank0", "rank1"] and len(names) == 3
    assert "Profiler trace written to: " + prof in out


def test_api_train_n_dp(tmp_path):
    """api.train(n_dp=2) takes the mesh (each rank's launch counts kept)
    and gives the single-device fit's weak rankers (RankBoost: the same
    sequence, α within 1e-5)."""
    import ranklib_tpu_torch.api as rl

    train, _ = _fixture()
    path = _files(tmp_path, train)[0]
    meshed = rl.train(path, ranker=2, n_rounds=15, n_dp=2, device="cpu")
    single = rl.train(path, ranker=2, n_rounds=15, device="cpu")
    assert len(meshed.rank_launches) == 2 and single.rank_launches is None
    _same_weaks(meshed.weaks, single.weaks)
