"""``-dp`` with a rank that holds no query, for the rankers that are not
trees (Coordinate Ascent, RankBoost, AdaRank, RankNet, LambdaRank,
ListNet), on the CPU: gloo ranks against the reference's ``make_mesh(n)``
fits, to the bounds of tests/test_torch_dp_rankers.py.

* -dp 4 on 3 training queries, dense and ``-sparse`` (CSR in; the dense
  device route), and on the COO route (``RANKLIB_TPU_DEVICE_DENSE_MB=0``)
  for CA and AdaRank.
* RankBoost at -dp 2 and 4 with a 1-query validation set: the ranks
  whose validation shard is empty still take part in its sum, so the
  mesh holds and the best-validation cut is the reference's.
* Every rank ends with the same model.

The port's fits run once for the module, in three spawned meshes
(``parallel.dp.fit_many``); each case holds one of them to its own
reference fit. The group timeout is cut to a minute, so a mismatched
collective fails fast instead of hanging.
"""

import jax
import numpy as np
import pytest
import torch

from ranklib_tpu.cli import main as ref_main
from ranklib_tpu.metrics.base import create_scorer as ref_scorer
from ranklib_tpu.models import neural as RN
from ranklib_tpu.parallel.dist import make_mesh as ref_mesh
from ranklib_tpu_torch.cli import main as port_main
from ranklib_tpu_torch.data.sparse import read_letor_sparse
from ranklib_tpu_torch.metrics.base import create_scorer
from ranklib_tpu_torch.models import neural as PN
from ranklib_tpu_torch.models.adarank import AdaRank
from ranklib_tpu_torch.models.coorascent import CoorAscent
from ranklib_tpu_torch.models.rankboost import RankBoost
from ranklib_tpu_torch.parallel import dist
from ranklib_tpu_torch.parallel import dp as PDP
from ranklib_tpu_torch.utils.logging import set_silent
from tests.test_torch_dp_empty_shards import _dataset, _ref_dataset

CPU = torch.device("cpu")
RANKERS = {"CoorAscent": dict(n_restart=2, max_passes=3),
           "RankBoost": dict(n_rounds=30), "AdaRank": dict(n_rounds=40),
           "RankNet": dict(n_epoch=3, learning_rate=0.001),
           "LambdaRank": dict(n_epoch=3, learning_rate=0.001),
           "ListNet": dict(n_epoch=3, learning_rate=0.01)}
PORT = {"CoorAscent": CoorAscent, "RankBoost": RankBoost,
        "AdaRank": AdaRank, "RankNet": PN.RankNet,
        "LambdaRank": PN.LambdaRank, "ListNet": PN.ListNet}
BUDGET_ENV = "RANKLIB_TPU_DEVICE_DENSE_MB"


def _ref_class(name):
    from ranklib_tpu.models.adarank import AdaRank as RefAda
    from ranklib_tpu.models.coorascent import CoorAscent as RefCA
    from ranklib_tpu.models.rankboost import RankBoost as RefRB

    return {"CoorAscent": RefCA, "RankBoost": RefRB, "AdaRank": RefAda,
            "RankNet": RN.RankNet, "LambdaRank": RN.LambdaRank,
            "ListNet": RN.ListNet}[name]


def _reference_draws(gen, sizes):
    """The reference's initial draws for the port's nets."""
    return [(np.asarray(W), np.asarray(b)) for W, b in RN._init_params(
        jax.random.PRNGKey(gen.initial_seed()), sizes)]


def _write(ds, path) -> str:
    from tests.fixtures import write_letor_text

    write_letor_text(ds, str(path))
    return str(path)


@pytest.fixture(autouse=True)
def _cpu_ranks(monkeypatch):
    monkeypatch.setenv("RANKLIB_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(dist, "TIMEOUT_S", 60)
    set_silent(False)
    yield
    set_silent(False)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The 3-query training file and the 1-query validation file."""
    d = tmp_path_factory.mktemp("empty_shards")
    return (_write(_ref_dataset(3), d / "train.txt"),
            _write(_ref_dataset(1, seed=10), d / "vali.txt"))


def _data(kind, files, package="port"):
    """(train, validation) of a kind: the dense fixture, or the files read
    as CSR (``-sparse``); the port's or the reference's classes."""
    if kind == "dense":
        if package == "port":
            return _dataset(3), _dataset(1, seed=10)
        return _ref_dataset(3), _ref_dataset(1, seed=10)
    if package == "port":
        return tuple(read_letor_sparse(p, quiet=True) for p in files)
    from ranklib_tpu.data.sparse import read_letor_sparse as ref_sparse

    return tuple(ref_sparse(p, quiet=True) for p in files)


@pytest.fixture(scope="module")
def mesh_fits(files):
    """The port's fits, run once: name → (ranker, every rank's model
    text). -dp 4: each ranker dense and -sparse, RankBoost with the
    1-query validation set; -dp 2: RankBoost with it; -dp 4 under a
    budget of 0: CA and AdaRank on the COO route."""
    scorer = create_scorer("NDCG@10")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RANKLIB_TPU_TORCH_DEVICE", "cpu")
        mp.setattr(dist, "TIMEOUT_S", 60)
        mp.setattr(PN, "_init_params", _reference_draws)
        seen = []
        check = PDP.check_same_rankers

        def keep(rankers):
            seen.append([r.model_str() for r in rankers])
            check(rankers)

        mp.setattr(PDP, "check_same_rankers", keep)
        set_silent(False)

        def run(n, fits):
            seen.clear()
            PDP.fit_many(dist.make_mesh(n, CPU), [
                (r, tr, scorer, va) for _, r, tr, va in fits])
            assert len(seen) == len(fits)
            out.update({name: (r, texts)
                        for (name, r, *_), texts in zip(fits, seen)})

        data = {kind: _data(kind, files) for kind in ("dense", "sparse")}
        run(4, [(f"{name}-{kind}", PORT[name](**hp), data[kind][0], None)
                for kind in data for name, hp in RANKERS.items()]
            + [(f"RankBoost-v1-{kind}-4", RankBoost(**RANKERS["RankBoost"]),
                *data[kind]) for kind in data])
        run(2, [(f"RankBoost-v1-{kind}-2", RankBoost(**RANKERS["RankBoost"]),
                 *data[kind]) for kind in data])
        mp.setenv(BUDGET_ENV, "0")
        run(4, [(f"{name}-coo", PORT[name](**RANKERS[name]),
                 data["sparse"][0], None)
                for name in ("CoorAscent", "AdaRank")])
    return out


def _ref_fit(name, train, val, n):
    ref = _ref_class(name)(**RANKERS[name])
    ref.fit(train, ref_scorer("NDCG@10"), val, mesh=ref_mesh(n))
    return ref


def _same_weaks(got, want, alpha_tol=1e-6):
    """RankBoost's (fid, θ, α) or AdaRank's (fid, α) records: all but α
    equal, α within ``alpha_tol``."""
    assert len(got) == len(want) > 0
    assert [w[:-1] for w in got] == [w[:-1] for w in want]
    assert max(abs(a[-1] - b[-1]) for a, b in zip(got, want)) < alpha_tol


def _hold(name, port, ref, ca_tol=1e-6):
    """The reference's bounds (tests/test_torch_dp_rankers.py)."""
    if name == "CoorAscent":
        np.testing.assert_allclose(port.weights, ref.weights, atol=ca_tol)
    elif name == "RankBoost":
        _same_weaks(port.weaks, ref.weaks)
    elif name == "AdaRank":
        _same_weaks(port.history, ref.history)
        np.testing.assert_allclose(port.weights, ref.weights, atol=1e-6)
    else:
        for (Wp, bp), (Wr, br) in zip(port.params, ref.params):
            np.testing.assert_allclose(Wp, np.asarray(Wr), atol=5e-5)
            np.testing.assert_allclose(bp, np.asarray(br), atol=5e-5)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("name", list(RANKERS))
def test_dp4_on_three_queries(files, mesh_fits, name, kind):
    """-dp 4 on 3 training queries: the reference's make_mesh(4) fit (the
    nets from its initial draws); every rank's model equal."""
    port, texts = mesh_fits[f"{name}-{kind}"]
    train, _ = _data(kind, files, "ref")
    _hold(name, port, _ref_fit(name, train, None, 4))
    assert len(texts) == 4 and len(set(texts)) == 1


@pytest.mark.parametrize("name", ["CoorAscent", "AdaRank"])
def test_dp4_on_three_queries_coo_route(files, mesh_fits, monkeypatch,
                                        name):
    """The COO route (a budget of 0) with empty ranks: the reference's COO
    mesh fit, CA's weights within its 2e-4; every rank's model equal."""
    monkeypatch.setenv(BUDGET_ENV, "0")
    port, texts = mesh_fits[f"{name}-coo"]
    train, _ = _data("sparse", files, "ref")
    _hold(name, port, _ref_fit(name, train, None, 4), ca_tol=2e-4)
    assert len(texts) == 4 and len(set(texts)) == 1


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_rankboost_with_one_validation_query(files, mesh_fits, kind, n):
    """RankBoost with a 1-query validation set at -dp n: the reference's
    weak rankers, cut at its best validation round, α within 1e-6; every
    rank's model equal."""
    port, texts = mesh_fits[f"RankBoost-v1-{kind}-{n}"]
    ref = _ref_fit("RankBoost", *_data(kind, files, "ref"), n)
    _same_weaks(port.weaks, ref.weaks)
    assert len(texts) == n and len(set(texts)) == 1


@pytest.mark.parametrize("n", ["2", "3", "4"])
def test_rankboost_one_query_validation_cli(tmp_path, capsys, files, n):
    """-ranker 2 -validate <1 query> -dp n through the CLI (the mesh that
    broke before every rank took part in the validation sum): rc 0 and
    the reference's result lines and weak rankers."""
    from ranklib_tpu_torch.models.base import load_ranker_file

    lines, models = {}, {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        m = str(tmp_path / f"{name}.txt")
        assert main(["-train", files[0], "-validate", files[1], "-ranker",
                     "2", "-round", "10", "-missingZero", "-metric2t",
                     "NDCG@10", "-dp", n, "-save", m]) == 0
        lines[name] = [ln for ln in capsys.readouterr().out.splitlines()
                       if " on " in ln and " data: " in ln]
        models[name] = load_ranker_file(m)
    assert lines["port"] == lines["ref"] and len(lines["port"]) == 2
    _same_weaks(models["port"].weaks, models["ref"].weaks)


@pytest.mark.parametrize("ranker", ["2", "3", "4"])
def test_training_line_dp4_cli(tmp_path, capsys, files, ranker):
    """-dp 4 on the 3-query file through the CLI with RankBoost, AdaRank
    and Coordinate Ascent: rc 0 and the reference's training line."""
    lines = {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        assert main(["-train", files[0], "-ranker", ranker, "-missingZero",
                     "-round", "10", "-r", "1", "-i", "5", "-metric2t",
                     "NDCG@10", "-dp", "4"]) == 0
        lines[name] = [ln for ln in capsys.readouterr().out.splitlines()
                       if " on training data: " in ln]
    assert lines["port"] == lines["ref"] and len(lines["port"]) >= 1
