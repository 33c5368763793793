"""``-sparse`` for the raw-value rankers — Coordinate Ascent (``-ranker
4``), RankBoost (2), AdaRank (3), Linear Regression (9), RankNet (1),
LambdaRank (5), ListNet (7) — against the reference's ``-sparse`` and the
port's own dense pipeline, on the CPU.

Both routes: the dense buckets materialized in bounded chunks (the
default) and the COO layer (``RANKLIB_TPU_DEVICE_DENSE_MB=0``).

* Each ranker's CSR fit against the reference's CSR fit on the same
  route: Coordinate Ascent's weights within 1e-6 (COO 2e-5, the
  reference's own COO tolerance); AdaRank's and RankBoost's picks equal,
  alphas within rtol 1e-5 (AdaRank's COO within 2e-5); Linear
  Regression's model text equal; the nets' parameters within 5e-5 from
  the reference's injected draws (the dense port-vs-reference tolerance).
* The port's CSR fit writes its dense fit's model text byte for byte at
  ``RANKLIB_TPU_SPARSE_CHUNK_MB`` 256 and 1, and scores alike; its COO
  fit is within the reference's tolerances of its dense fit (CA 2e-5,
  AdaRank picks equal and alphas 2e-5, nets 1e-6), also under ``-norm
  zscore``, where the COO holds every present (doc, feature) pair.
* The CLI with ``-sparse``: ``-qrel``, ``-feature``, ``-tvs``, ``-tts``,
  ``-norm``, ``-kcv 3`` and ``-load -test/-rank`` print the reference's
  lines and write its idv files (scores within 1e-5, the last printed
  digit) and the port's dense flow's bytes.
"""

import os

import jax
import numpy as np
import pytest
import torch

from ranklib_tpu.cli import main as ref_main
from ranklib_tpu.data.sparse import read_letor_sparse as ref_read_sparse
from ranklib_tpu.metrics.base import create_scorer as ref_create_scorer
from ranklib_tpu.models import adarank as RA
from ranklib_tpu.models import coorascent as RC
from ranklib_tpu.models import linear as RL
from ranklib_tpu.models import neural as RN
from ranklib_tpu.models import rankboost as RR
from ranklib_tpu_torch.cli import main as port_main
from ranklib_tpu_torch.data.letor import read_letor
from ranklib_tpu_torch.data.sparse import normalize_csr, read_letor_sparse
from ranklib_tpu_torch.metrics.base import create_scorer
from ranklib_tpu_torch.models import adarank as PA
from ranklib_tpu_torch.models import coorascent as PC
from ranklib_tpu_torch.models import linear as PL
from ranklib_tpu_torch.models import neural as PN
from ranklib_tpu_torch.models import rankboost as PR
from ranklib_tpu_torch.utils.logging import set_silent
from tests.fixtures import synth_dataset

CPU = torch.device("cpu")
BUDGET = "RANKLIB_TPU_DEVICE_DENSE_MB"
# (reference class, port class, hyperparameters, takes validation)
RANKERS = {
    "ca": (RC.CoorAscent, PC.CoorAscent,
           dict(n_restart=2, max_passes=3), True),
    "rankboost": (RR.RankBoost, PR.RankBoost,
                  dict(n_rounds=10, n_threshold=6), True),
    "adarank": (RA.AdaRank, PA.AdaRank, dict(n_rounds=8), True),
    "linear": (RL.LinearRegRank, PL.LinearRegRank, {}, False),
    "ranknet": (RN.RankNet, PN.RankNet,
                dict(n_epoch=3, learning_rate=0.001), True),
    "lambdarank": (RN.LambdaRank, PN.LambdaRank,
                   dict(n_epoch=3, learning_rate=0.001), False),
    "listnet": (RN.ListNet, PN.ListNet,
                dict(n_epoch=3, learning_rate=0.01), False),
}
COO_RANKERS = ("ca", "adarank", "ranknet", "lambdarank", "listnet")


def _ref_init(gen, sizes):
    return [(np.asarray(W), np.asarray(b)) for W, b in RN._init_params(
        jax.random.PRNGKey(gen.initial_seed()), sizes)]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The port on the CPU, its nets started from the reference's draws."""
    monkeypatch.setenv("RANKLIB_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(PN, "_init_params", _ref_init)


def _write_sparse(ds, path, rng, keep=0.4):
    """LETOR text keeping ~``keep`` of the (doc, fid) pairs (at least one a
    line) and a '#' docid a line."""
    with open(path, "w") as f:
        for q in ds.queries:
            for i in range(q.n):
                on = rng.random(q.feats.shape[1]) < keep
                on[rng.integers(q.feats.shape[1])] = True
                toks = " ".join(f"{j + 1}:{q.feats[i, j]:.6g}"
                                for j in np.flatnonzero(on))
                f.write(f"{int(q.labels[i])} qid:{q.qid} {toks} "
                        f"# d{q.qid}_{i}\n")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_sparse_raw")
    rng = np.random.default_rng(17)
    out = {"dir": d}
    for name, nq, seed in (("train", 12, 201), ("vali", 4, 205),
                           ("test", 5, 202)):
        ds = synth_dataset(n_queries=nq, n_features=9, min_docs=5,
                           max_docs=14, gmax=2, seed=seed, w_seed=201)
        out[name] = str(d / f"{name}.txt")
        _write_sparse(ds, out[name], rng)
    out["qrel"] = str(d / "judgments.qrel")
    with open(out["train"]) as f, open(out["qrel"], "w") as g:
        for line in f:
            qid, doc = line.split()[1][4:], line.split("#")[1].strip()
            g.write(f"{qid} 0 {doc} {int(rng.integers(0, 3))}\n")
    out["feature"] = str(d / "features.txt")
    with open(out["feature"], "w") as f:
        f.write("# five of nine\n1\n2\n4\n5\n8\n")
    return out


def _env(route):
    mp = pytest.MonkeyPatch()
    if route == "coo":
        mp.setenv(BUDGET, "0")
    else:
        mp.delenv(BUDGET, raising=False)
    return mp


def _fit_ref(name, files, route, norm=None):
    ref_cls, _, hp, val = RANKERS[name]
    train = ref_read_sparse(files["train"], quiet=True)
    vali = ref_read_sparse(files["vali"], quiet=True) if val else None
    if norm:
        from ranklib_tpu.data.sparse import normalize_csr as ref_norm
        train = ref_norm(train, norm)
        vali = ref_norm(vali, norm) if vali is not None else None
    mp = _env(route)
    try:
        ref = ref_cls(**hp)
        ref.fit(train, ref_create_scorer("NDCG@10"), vali)
    finally:
        mp.undo()
    return ref


@pytest.fixture(scope="module")
def ref_fits(files):
    """The reference's -sparse fits, one a (ranker, route), shared."""
    cache = {}

    def get(name, route, norm=None):
        key = (name, route, norm)
        if key not in cache:
            cache[key] = _fit_ref(name, files, route, norm)
        return cache[key]
    return get


def _fit_port(name, files, route, sparse=True, norm=None):
    _, port_cls, hp, val = RANKERS[name]
    read = ((lambda p: read_letor_sparse(p, quiet=True)) if sparse else
            (lambda p: read_letor(p, missing_zero=True)))
    train = read(files["train"])
    vali = read(files["vali"]) if val else None
    if norm:
        assert sparse
        train = normalize_csr(train, norm)
        vali = normalize_csr(vali, norm) if vali is not None else None
    mp = _env(route)
    set_silent(True)
    try:
        port = port_cls(**hp)
        port.fit(train, create_scorer("NDCG@10"), vali, device=CPU)
    finally:
        set_silent(False)
        mp.undo()
    return port, train


def _assert_close(name, got, want, coo):
    """``got`` against ``want`` (either package) within the route's
    tolerance for the ranker."""
    if name == "ca":
        np.testing.assert_allclose(got.weights, want.weights, rtol=0,
                                   atol=2e-5 if coo else 1e-6)
    elif name == "adarank":
        assert len(got.history) == len(want.history) > 0
        assert [f for f, _ in got.history] == [f for f, _ in want.history]
        a, b = ([x for _, x in h] for h in (got.history, want.history))
        if coo:
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5)
    elif name == "rankboost":
        assert len(got.weaks) == len(want.weaks) > 0
        assert [w[:2] for w in got.weaks] == [w[:2] for w in want.weaks]
        np.testing.assert_allclose([w[2] for w in got.weaks],
                                   [w[2] for w in want.weaks], rtol=1e-5)
    elif name == "linear":
        assert got.model_str() == want.model_str()
    else:
        for (Wg, bg), (Ww, bw) in zip(got.params, want.params):
            np.testing.assert_allclose(Wg, np.asarray(Ww), rtol=0, atol=5e-5)
            np.testing.assert_allclose(bg, np.asarray(bw), rtol=0, atol=5e-5)


CASES = ([(n, "dense") for n in RANKERS]
         + [(n, "coo") for n in COO_RANKERS])


@pytest.mark.parametrize("name,route", CASES,
                         ids=[f"{n}-{r}" for n, r in CASES])
def test_sparse_fit_matches_the_reference(files, ref_fits, name, route):
    port, _ = _fit_port(name, files, route)
    _assert_close(name, port, ref_fits(name, route), route == "coo")


@pytest.mark.parametrize("name", COO_RANKERS)
def test_coo_fit_is_close_to_the_dense_fit(files, name):
    """The reference's own COO tolerances (tests/test_sparse_csr.py:687,
    :757-760, :809-810)."""
    coo, _ = _fit_port(name, files, "coo")
    dense, _ = _fit_port(name, files, "dense", sparse=False)
    if name in ("ca", "adarank"):
        _assert_close(name, coo, dense, coo=True)
    else:
        for (Wc, bc), (Wd, bd) in zip(coo.params, dense.params):
            np.testing.assert_allclose(Wc, Wd, rtol=0, atol=1e-6)
            np.testing.assert_allclose(bc, bd, rtol=0, atol=1e-6)


@pytest.mark.parametrize("chunk_mb", ["256", "1"])
@pytest.mark.parametrize("name", list(RANKERS))
def test_csr_fit_writes_the_dense_fits_model(files, monkeypatch, name,
                                             chunk_mb):
    """Chunking changes no sum: the CSR fit's model text and scores are
    the dense fit's, byte for byte."""
    monkeypatch.setenv("RANKLIB_TPU_SPARSE_CHUNK_MB", chunk_mb)
    csr, csr_ds = _fit_port(name, files, "dense")
    dense, dense_ds = _fit_port(name, files, "dense", sparse=False)
    assert csr.model_str() == dense.model_str()
    for a, b in zip(csr.eval_dataset(csr_ds, CPU),
                    dense.eval_dataset(dense_ds, CPU)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["ca", "ranknet"])
def test_zscore_through_the_coo_route(files, ref_fits, name):
    """Lazy -norm zscore makes each query's implicit zeros nonzero: the
    COO fit against the port's chunked CSR fit and the reference's COO
    fit under the same normalization."""
    coo, _ = _fit_port(name, files, "coo", norm="zscore")
    dense, _ = _fit_port(name, files, "dense", norm="zscore")
    if name == "ca":
        _assert_close(name, coo, dense, coo=True)
    else:
        for (Wc, bc), (Wd, bd) in zip(coo.params, dense.params):
            np.testing.assert_allclose(Wc, Wd, rtol=0, atol=1e-6)
            np.testing.assert_allclose(bc, bd, rtol=0, atol=1e-6)
    _assert_close(name, coo, ref_fits(name, "coo", "zscore"), coo=True)


# ---- the CLI -----------------------------------------------------------------

def _lines(out):
    return [ln for ln in out.splitlines()
            if (" on " in ln and "data:" in ln) or ln.startswith(
                ("Fold ", "Avg.", "Train-test split", "Relevance"))]


def _rows(path):
    """A score, idv or indri file as (text columns, numbers) rows."""
    rows = [ln.split() for ln in open(path)]
    return ([[t for t in r if not _num(t)] for r in rows],
            np.array([float(t) for r in rows for t in r if _num(t)
                      and "." in t]))


def _num(t):
    try:
        float(t)
        return True
    except ValueError:
        return False


FLOWS = {
    "qrel": (["-ranker", "9", "-qrel", "{qrel}", "-test", "{test}",
              "-idv", "{out}.idv"], "dense"),
    "feature": (["-ranker", "3", "-round", "6", "-feature", "{feature}",
                 "-validate", "{vali}", "-test", "{test}"], "dense"),
    "tvs-norm": (["-r", "1", "-i", "5", "-tvs", "0.7", "-norm", "zscore",
                  "-test", "{test}", "-idv", "{out}.idv"], "dense"),
    "tts": (["-ranker", "2", "-round", "8", "-tc", "5", "-tts", "0.6"],
            "dense"),
    "kcv": (["-ranker", "9", "-kcv", "3", "-kcvmd", "{out}.folds",
             "-kcvmn", "m"], "dense"),
    "coo-adarank": (["-ranker", "3", "-round", "6", "-validate", "{vali}",
                     "-test", "{test}", "-idv", "{out}.idv"], "coo"),
    "coo-ranknet": (["-ranker", "1", "-epoch", "2", "-lr", "0.001",
                     "-norm", "sum", "-test", "{test}", "-idv",
                     "{out}.idv"], "coo"),
}


@pytest.mark.parametrize("flow", list(FLOWS))
def test_cli_flows_match_the_reference(files, tmp_path, capsys, flow):
    """The same command line through the reference's CLI with -sparse,
    the port's with -sparse and the port's without: the same printed
    lines; idv files equal in their qids and within 1e-5."""
    args, route = FLOWS[flow]
    outs = {}
    for name, main, extra in (("ref", ref_main, ["-sparse"]),
                              ("port", port_main, ["-sparse"]),
                              ("dense", port_main, [])):
        if name == "dense" and route == "coo":
            continue
        fmt = {k: v for k, v in files.items() if k != "dir"}
        fmt["out"] = str(tmp_path / name)
        argv = ["-train", files["train"], "-metric2t", "NDCG@10",
                "-missingZero", *[a.format(**fmt) for a in args], *extra]
        mp = _env(route)
        try:
            assert main(argv) == 0
        finally:
            mp.undo()
        out = capsys.readouterr().out
        idv = fmt["out"] + ".idv"
        outs[name] = (_lines(out), _rows(idv) if os.path.exists(idv)
                      else None, out)
        if flow == "kcv":
            outs[name] += ([open(os.path.join(fmt["out"] + ".folds",
                                              f"f{i}.m")).read()
                            for i in (1, 2, 3)],)
    assert outs["port"][0] == outs["ref"][0], (outs["port"][2],
                                               outs["ref"][2])
    assert len(outs["port"][0]) >= (5 if flow == "kcv" else 2)
    if outs["port"][1] is not None:
        assert outs["port"][1][0] == outs["ref"][1][0]
        np.testing.assert_allclose(outs["port"][1][1], outs["ref"][1][1],
                                   atol=1e-4)
    if "dense" in outs:
        assert outs["port"][0] == outs["dense"][0]
        if outs["port"][1] is not None:
            assert outs["port"][1][0] == outs["dense"][1][0]
            np.testing.assert_array_equal(outs["port"][1][1],
                                          outs["dense"][1][1])
        if flow == "kcv":
            assert outs["port"][3] == outs["dense"][3]
            assert outs["port"][3] == outs["ref"][3]


@pytest.fixture(scope="module")
def models(files, tmp_path_factory):
    """Models the reference trained on the sparse file, one a raw-value
    ranker family."""
    d = tmp_path_factory.mktemp("raw_models")
    out = {}
    for r, extra in (("4", ["-r", "1", "-i", "5"]), ("2", ["-round", "8"]),
                     ("1", ["-epoch", "2"])):
        out[r] = str(d / f"m{r}.txt")
        assert ref_main(["-train", files["train"], "-ranker", r,
                         "-missingZero", "-silent", *extra,
                         "-save", out[r]]) == 0
    return out


@pytest.mark.parametrize("ranker", ["4", "2", "1"])
def test_load_test_and_rank_match_the_reference(files, models, tmp_path,
                                                capsys, ranker):
    """-load <raw-value model> -test/-rank -sparse: the reference's line,
    idv, score and indri files (scores to the last printed digit), and
    the port's dense flow's bytes."""
    outs = {}
    for name, main, extra in (("ref", ref_main, ["-sparse"]),
                              ("port", port_main, ["-sparse"]),
                              ("dense", port_main, [])):
        p = str(tmp_path / name)
        assert main(["-load", models[ranker], "-test", files["test"],
                     "-metric2T", "ERR@5", "-missingZero", "-idv",
                     p + ".idv", *extra]) == 0
        assert main(["-load", models[ranker], "-rank", files["test"],
                     "-score", p + ".score", "-indri", p + ".indri",
                     "-missingZero", *extra]) == 0
        outs[name] = (_lines(capsys.readouterr().out),
                      [open(p + s).read() for s in (".idv", ".score",
                                                    ".indri")])
    assert outs["port"] == outs["dense"]
    assert outs["port"][0] == outs["ref"][0]
    for got, want in zip(outs["port"][1], outs["ref"][1]):
        g = [ln.split() for ln in got.splitlines()]
        w = [ln.split() for ln in want.splitlines()]
        assert [[t for t in r if not _num(t) or "." not in t] for r in g] \
            == [[t for t in r if not _num(t) or "." not in t] for r in w]
        np.testing.assert_allclose(
            [float(t) for r in g for t in r if _num(t) and "." in t],
            [float(t) for r in w for t in r if _num(t) and "." in t],
            atol=1e-5)


def test_classes_split_over_chunks_keep_the_dense_sums(tmp_path,
                                                       monkeypatch):
    """At 800 features a 1 MB chunk holds 20 of the size class's 24
    queries, so the class comes in two host chunks; they are joined on
    the device, Linear Regression sums the dense blocks and both score in
    the same row blocks, so every model and score is still the dense
    fit's, byte for byte (Coordinate Ascent shares AdaRank's evaluator
    and Linear Regression's scoring)."""
    rng = np.random.default_rng(23)
    path = str(tmp_path / "wide.txt")
    ds = synth_dataset(n_queries=24, n_features=800, min_docs=14,
                       max_docs=16, gmax=2, seed=231)
    _write_sparse(ds, path, rng, keep=0.01)
    monkeypatch.setenv("RANKLIB_TPU_SPARSE_CHUNK_MB", "1")
    csr = read_letor_sparse(path, quiet=True)
    dense = read_letor(path, missing_zero=True)
    from ranklib_tpu_torch.data.dataset import iter_buckets
    from ranklib_tpu_torch.ops.batched_eval import row_blocks
    assert len(list(iter_buckets(csr, with_feats=True))) > len(
        list(iter_buckets(dense, with_feats=True)))
    assert len(list(row_blocks(csr)[1])) > 1        # scored in two blocks
    scorer = create_scorer("NDCG@10")
    set_silent(True)
    try:
        for cls, hp, val in (
                (PA.AdaRank, dict(n_rounds=4), True),
                (PR.RankBoost, dict(n_rounds=5), False),
                (PL.LinearRegRank, {}, False),
                (PN.RankNet, dict(n_epoch=1, learning_rate=0.01), True)):
            got = []
            for d in (csr, dense):
                r = cls(**hp)
                r.fit(d, scorer, d if val else None, device=CPU)
                got.append((r.model_str(), r.eval_dataset(d, CPU)))
            assert got[0][0] == got[1][0], cls.NAME
            for a, b in zip(got[0][1], got[1][1]):
                np.testing.assert_array_equal(a, b)
    finally:
        set_silent(False)
