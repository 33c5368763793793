"""The port's training extensions against the reference's on the CPU:
``-ckpt``, ``-resume`` (dense and streamed), the warm start of a loaded
model, ``-eventlog``, ``-profile``, the library API and model files
across the packages.

* Checkpoints and resumed fits: every tree's structure and thresholds
  equal to the reference's, leaf outputs to rtol 1e-5 (the packages' f32
  sums run in other orders, so model files are not byte-identical).
* Event records: the same records field for field less ``t``; integers,
  strings and None exactly, floats to 1e-5 (the metrics of fits that agree
  to f32 rounding).
* The API: the same datasets, metrics to 1e-6, scores to 1e-5, the same
  permutations.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

import ranklib_tpu.api as ref_api
from ranklib_tpu.cli import main as ref_main
from ranklib_tpu.metrics.base import create_scorer as ref_scorer
from ranklib_tpu.models.base import load_ranker_file as ref_load
from ranklib_tpu.models.gbdt import MART as RefMART
from ranklib_tpu.models.gbdt import LambdaMART as RefLambdaMART
from ranklib_tpu.models.trainer import train_ranker as ref_train_ranker
from ranklib_tpu.utils.errors import RankLibError as RefError
from ranklib_tpu.utils.logging import set_event_log as ref_set_event_log
import ranklib_tpu_torch.api as port_api
from ranklib_tpu_torch.cli import main as port_main
from ranklib_tpu_torch.data.binned import read_letor_binned
from ranklib_tpu_torch.data.letor import read_letor
from ranklib_tpu_torch.metrics.base import create_scorer, score_dataset
from ranklib_tpu_torch.models.base import load_ranker_file as port_load
from ranklib_tpu_torch.models.gbdt import MART, LambdaMART
from ranklib_tpu_torch.models.trainer import train_ranker
from ranklib_tpu_torch.utils.errors import RankLibError
from ranklib_tpu_torch.utils.logging import set_silent
from tests.fixtures import synth_dataset, write_letor_text

CPU = torch.device("cpu")
TREE_FIELDS = ("feature", "threshold", "left", "right", "is_leaf")


@pytest.fixture(autouse=True)
def _port_defaults(monkeypatch):
    monkeypatch.setenv("RANKLIB_TPU_TORCH_DEVICE", "cpu")
    set_silent(False)
    yield
    set_silent(False)
    ref_set_event_log(None)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_ext")
    paths = {}
    for name, nq, seed in (("train", 14, 21), ("vali", 6, 22),
                           ("test", 6, 23)):
        paths[name] = str(d / f"{name}.txt")
        write_letor_text(synth_dataset(n_queries=nq, n_features=6,
                                       min_docs=5, max_docs=20, seed=seed,
                                       w_seed=21, signal=3.0), paths[name])
    return d, paths


def _same_trees(ref_ens, port_ens, n=None):
    assert len(port_ens.trees) == len(ref_ens.trees)
    assert port_ens.weights == ref_ens.weights
    for i, (a, b) in enumerate(zip(ref_ens.trees[:n], port_ens.trees[:n])):
        for f in TREE_FIELDS:
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f),
                                          err_msg=f"tree {i} {f}")
        np.testing.assert_allclose(b.output, a.output, rtol=1e-5, atol=1e-6,
                                   err_msg=f"tree {i} output")


def _recording_saves(ranker, texts):
    """Keep the model text of every save (each checkpoint)."""
    save = ranker.save

    def rec(path):
        texts.append(ranker.model_str())
        save(path)

    ranker.save = rec


@pytest.mark.parametrize("name", ["LambdaMART", "MART"])
def test_checkpoints_match_reference(files, tmp_path, name):
    """tests/test_gbdt.py:258-282: -ckpt 4 over 10 rounds writes the 4- and
    8-tree models; each checkpoint's trees are the reference's, and the
    file holds the last one. A resume from it runs to 10 trees, the
    prior trees verbatim, within 0.05 of the straight fit (the
    reference's bound)."""
    d, paths = files
    ref_cls, port_cls = {"LambdaMART": (RefLambdaMART, LambdaMART),
                         "MART": (RefMART, MART)}[name]
    hp = dict(n_trees=10, n_leaves=4, learning_rate=0.2, ckpt_every=4)
    ref_texts, port_texts = [], []
    ref = ref_cls(ckpt_path=str(tmp_path / "ref.ckpt"), **hp)
    _recording_saves(ref, ref_texts)
    ref.fit(ref_api.read(paths["train"]), ref_scorer("NDCG@10"))
    port = port_cls(ckpt_path=str(tmp_path / "port.ckpt"), **hp)
    _recording_saves(port, port_texts)
    train = port_api.read(paths["train"])
    scorer = create_scorer("NDCG@10")
    port.fit(train, scorer, device=CPU)
    assert len(port_texts) == len(ref_texts) == 2
    for r, p in zip(ref_texts, port_texts):
        a, b = ref_cls(), port_cls()
        a.load_str(r)
        b.load_str(p)
        _same_trees(a.ensemble, b.ensemble)
    ck = port_load(str(tmp_path / "port.ckpt"))
    assert ck.model_str() == port_texts[-1] and len(ck.ensemble) == 8
    ck.n_trees = 10
    ck.fit(train, scorer, device=CPU)
    assert len(ck.ensemble) == 10
    assert (ck.ensemble.to_text().split("</tree>")[:8]
            == port.ensemble.to_text().split("</tree>")[:8])
    m_full, _ = score_dataset(scorer, train, port.eval_dataset(train, CPU),
                              CPU)
    m_res, _ = score_dataset(scorer, train, ck.eval_dataset(train, CPU), CPU)
    assert abs(m_full - m_res) < 0.05


@pytest.mark.parametrize("name", ["LambdaMART", "MART"])
def test_warm_start_of_a_loaded_model(files, tmp_path, name):
    """The repaired divergence: load_ranker_file(m).fit(...) continues the
    model, as the reference's fit does (ranklib_tpu/models/gbdt.py:134-160):
    the 5 prior trees kept, 3 rounds trained, the trees the reference's
    warm start grows (with validation: the rollback counts new rounds)."""
    d, paths = files
    ref_cls, port_cls = {"LambdaMART": (RefLambdaMART, LambdaMART),
                         "MART": (RefMART, MART)}[name]
    prior = ref_cls(n_trees=5, n_leaves=4, learning_rate=0.2)
    prior.fit(ref_api.read(paths["train"]), ref_scorer("NDCG@10"))
    m = str(tmp_path / "prior.txt")
    prior.save(m)
    ref = ref_load(m)
    ref.n_trees = 8
    ref.fit(ref_api.read(paths["train"]), ref_scorer("NDCG@10"),
            ref_api.read(paths["vali"]))
    port = port_load(m)
    port.n_trees = 8
    port.fit(port_api.read(paths["train"]), create_scorer("NDCG@10"),
             port_api.read(paths["vali"]), device=CPU)
    assert 5 < len(port.ensemble) <= 8
    assert (port.ensemble.to_text().split("</tree>")[:5]
            == port_load(m).ensemble.to_text().split("</tree>")[:5])
    _same_trees(ref.ensemble, port.ensemble)


def test_streamed_resume_equals_dense(files):
    """tests/test_stream_binned.py:166-185: a warm start on the streamed
    bin matrix (the prior scored in bin space) writes the dense warm
    start's model bytes; both grow the reference's trees."""
    _, paths = files
    scorer = create_scorer("NDCG@10")
    dense = read_letor(paths["train"])
    half = LambdaMART(n_trees=5, n_leaves=4)
    half.fit(dense, scorer, device=CPU)
    models = []
    for ds in (dense, read_letor_binned(paths["train"])):
        r = LambdaMART(n_trees=10, n_leaves=4)
        r.load_str(half.model_str())
        r.n_trees = 10
        r.fit(ds, scorer, device=CPU)
        models.append(r)
    assert models[1].model_str() == models[0].model_str()
    rhalf = RefLambdaMART(n_trees=5, n_leaves=4)
    rhalf.load_str(half.model_str())
    rhalf.n_trees = 10
    rhalf.fit(ref_api.read(paths["train"]), ref_scorer("NDCG@10"))
    _same_trees(rhalf.ensemble, models[0].ensemble)


def test_resume_cli_matches_reference(files, tmp_path, capsys):
    """-resume through both CLIs: the warm-start line and the same result
    lines; the saved model's first 5 trees are the resumed file's."""
    _, paths = files
    m = str(tmp_path / "m5.txt")
    assert ref_main(["-train", paths["train"], "-ranker", "6", "-tree", "5",
                     "-leaf", "4", "-metric2t", "NDCG@10", "-save", m]) == 0
    capsys.readouterr()
    out = {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        save = str(tmp_path / f"{name}.txt")
        assert main(["-train", paths["train"], "-ranker", "6", "-tree", "9",
                     "-leaf", "4", "-metric2t", "NDCG@10", "-resume", m,
                     "-test", paths["test"], "-save", save]) == 0
        out[name] = [ln for ln in capsys.readouterr().out.splitlines()
                     if ln.startswith("Warm start") or " data: " in ln]
        ens = port_load(save).ensemble.to_text().split("</tree>")
        assert ens[:5] == port_load(m).ensemble.to_text().split("</tree>")[:5]
        assert len(ens) == 10                       # 9 trees and the tail
    assert out["port"] == out["ref"]
    assert out["port"][0] == "Warm start from 5 trees (4 rounds to go)"


@pytest.mark.parametrize("case", ["other-ranker", "not-a-tree-ranker"])
def test_resume_errors_word_for_word(files, tmp_path, capsys, case):
    """ranklib_tpu/models/trainer.py:36-50: a model of another ranker, and
    (reachable from the library, the CLI routes -resume to 0 and 6 only) a
    ranker that is no tree ranker."""
    _, paths = files
    if case == "other-ranker":
        m = str(tmp_path / "mart.txt")
        assert ref_main(["-train", paths["train"], "-ranker", "0", "-tree",
                         "2", "-leaf", "3", "-save", m]) == 0
        capsys.readouterr()
        lines = {}
        for name, main in (("ref", ref_main), ("port", port_main)):
            assert main(["-train", paths["train"], "-ranker", "6",
                         "-resume", m]) == 1
            lines[name] = capsys.readouterr().out.splitlines()[-1]
        assert lines["port"] == lines["ref"]
        assert lines["port"] == ("Error: -resume model is a MART, not a "
                                 "LambdaMART")
        return
    m = str(tmp_path / "lin.txt")
    assert ref_main(["-train", paths["train"], "-ranker", "9", "-save",
                     m]) == 0
    with pytest.raises(RefError) as ref_e:
        ref_train_ranker(9, ref_api.read(paths["train"]),
                         ref_scorer("NDCG@10"), None, {"_resume_from": m})
    with pytest.raises(RankLibError) as port_e:
        train_ranker(9, port_api.read(paths["train"]),
                     create_scorer("NDCG@10"), None, {"_resume_from": m},
                     CPU)
    assert str(port_e.value) == str(ref_e.value) == (
        "-resume is only supported for tree rankers (got Linear Regression)")


def test_resume_and_ckpt_dropped_for_other_rankers(files, tmp_path, capsys,
                                                   monkeypatch):
    """The reference routes -resume and -ckpt to MART and LambdaMART only
    and drops them silently for the others (ranklib_tpu/cli.py:133,
    :157-160): with -ranker 4 both CLIs train, print the same lines and
    write no checkpoint, even with a -resume file that does not exist."""
    _, paths = files
    monkeypatch.chdir(tmp_path)
    lines = {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        assert main(["-train", paths["train"], "-ranker", "4", "-r", "1",
                     "-i", "3", "-metric2t", "NDCG@10", "-resume",
                     "missing.txt", "-ckpt", "1", "-save",
                     f"{name}.txt"]) == 0
        lines[name] = [ln for ln in capsys.readouterr().out.splitlines()
                       if " data: " in ln]
    assert lines["port"] == lines["ref"] and lines["port"]
    assert not glob.glob("*.ckpt") and not os.path.exists("model.ckpt")


def _events(path):
    return [{k: v for k, v in json.loads(ln).items() if k != "t"}
            for ln in open(path)] if os.path.exists(path) else []


@pytest.mark.parametrize("ranker,extra", [
    ("6", ["-tree", "6", "-leaf", "4"]),
    ("4", ["-r", "2", "-i", "3"]),
    ("2", ["-round", "8"]),
    ("3", ["-round", "8"]),
    ("1", ["-epoch", "3"]),
    ("9", []),
], ids=["lambdamart", "coorascent", "rankboost", "adarank", "ranknet",
        "linear"])
def test_eventlog_matches_reference(files, tmp_path, monkeypatch, ranker,
                                    extra):
    """tests/test_cli_flows.py:113-121: the records of -eventlog, field by
    field less "t": LambdaMART's, RankBoost's and AdaRank's "round", CA's
    "sweep", RankNet's "epoch" (from the reference's initial draws);
    Linear Regression writes none."""
    _, paths = files
    if ranker == "1":
        import jax

        from ranklib_tpu.models import neural as RN
        from ranklib_tpu_torch.models import neural as PN

        monkeypatch.setattr(PN, "_init_params", lambda gen, sizes: [
            (np.asarray(W), np.asarray(b)) for W, b in RN._init_params(
                jax.random.PRNGKey(gen.initial_seed()), sizes)])
    recs = {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        ev = str(tmp_path / f"{name}.jsonl")
        assert main(["-train", paths["train"], "-ranker", ranker,
                     "-metric2t", "NDCG@10", "-validate", paths["vali"],
                     "-eventlog", ev, *extra]) == 0
        ref_set_event_log(None)
        recs[name] = _events(ev)
    if ranker == "9":
        assert recs["port"] == recs["ref"] == []
        return
    assert len(recs["port"]) == len(recs["ref"]) > 0
    for r, p in zip(recs["ref"], recs["port"]):
        assert p.keys() == r.keys()
        for k, v in r.items():
            if isinstance(v, float):
                assert p[k] == pytest.approx(v, abs=1e-5), (k, r, p)
            else:
                assert p[k] == v, (k, r, p)


def test_eventlog_appends_and_silent_writes_no_rounds(files, tmp_path):
    """The log is appended to, one JSON object a line; a -silent run
    writes no "round" records (the reference emits them with the table)."""
    _, paths = files
    ev = str(tmp_path / "ev.jsonl")
    args = ["-train", paths["train"], "-ranker", "6", "-tree", "3", "-leaf",
            "4", "-metric2t", "NDCG@10", "-eventlog", ev]
    assert port_main(args) == 0
    assert port_main(args) == 0
    assert port_main([*args, "-silent"]) == 0
    recs = _events(ev)
    assert [r["round"] for r in recs] == [1, 2, 3, 1, 2, 3]
    assert all(r["ranker"] == "LambdaMART" and r["val_metric"] is None
               for r in recs)


@pytest.mark.parametrize("kcv", [False, True], ids=["train", "kcv"])
def test_profile_writes_a_trace(files, tmp_path, capsys, kcv):
    """-profile: the directory, its torch.profiler trace and the
    reference's line; with -kcv one directory a fold (ref
    evaluator.py:465-473)."""
    _, paths = files
    prof = str(tmp_path / "prof")
    args = ["-train", paths["train"], "-ranker", "6", "-tree", "2", "-leaf",
            "3", "-metric2t", "NDCG@10", "-profile", prof]
    if kcv:
        args += ["-kcv", "2"]
    assert port_main(args) == 0
    out = capsys.readouterr().out
    dirs = ([os.path.join(prof, "fold1"), os.path.join(prof, "fold2")]
            if kcv else [prof])
    for d in dirs:
        traces = glob.glob(os.path.join(d, "*.pt.trace.json"))
        assert len(traces) == 1
        with open(traces[0]) as f:
            assert json.load(f)["traceEvents"]
        assert f"Profiler trace written to: {d}" in out


def test_api_matches_reference(files, tmp_path):
    """tests/test_cli_flows.py:170-240 against the reference's api on the
    same files: read, train (ranker name and id), evaluate (mean and per
    query), score, rank, save and load, and the sparse read."""
    _, paths = files
    rds, pds = ref_api.read(paths["train"]), port_api.read(paths["train"])
    assert [q.qid for q in pds.queries] == [q.qid for q in rds.queries]
    for a, b in zip(rds.queries, pds.queries):
        np.testing.assert_array_equal(b.labels, a.labels)
        np.testing.assert_array_equal(b.feats, a.feats)
    rm = ref_api.train(rds, ranker="Linear Regression", metric="NDCG@10")
    pm = port_api.train(pds, ranker="Linear Regression", metric="NDCG@10",
                        device="cpu")
    m = port_api.evaluate(pm, pds, metric="NDCG@10")
    assert m == pytest.approx(ref_api.evaluate(rm, rds, metric="NDCG@10"),
                              abs=1e-6)
    mean, pq = port_api.evaluate(pm, paths["train"], per_query=True)
    _, rpq = ref_api.evaluate(rm, paths["train"], per_query=True)
    assert mean == pytest.approx(m, abs=1e-9) and len(pq) == 14
    np.testing.assert_allclose(pq, rpq, atol=1e-6)
    for a, b in zip(ref_api.score(rm, rds), port_api.score(pm, pds)):
        np.testing.assert_allclose(b, a, atol=1e-5)
    for a, b in zip(ref_api.rank(rm, rds), port_api.rank(pm, pds)):
        np.testing.assert_array_equal(b, a)
    mp = str(tmp_path / "m.txt")
    port_api.save(pm, mp)
    for a, b in zip(port_api.score(pm, pds),
                    port_api.score(port_api.load(mp), pds)):
        np.testing.assert_allclose(b, a, atol=1e-6)
    assert ref_api.load(mp).model_str() == open(mp).read()
    rlm = ref_api.train(rds, ranker=6, n_trees=3, n_leaves=4)
    plm = port_api.train(pds, ranker=6, n_trees=3, n_leaves=4)
    _same_trees(rlm.ensemble, plm.ensemble)
    csr = port_api.read(paths["train"], sparse=True)
    assert type(csr).__name__ == "CSRDataset"
    np.testing.assert_allclose(
        port_api.train(csr, ranker=9).weights, pm.weights, atol=1e-9)


def test_api_rank_is_stable(files):
    """Ties keep document order (ref api.py:123-133)."""
    _, paths = files
    ds = port_api.read(paths["test"])
    model = port_api.train(paths["train"], ranker=6, n_trees=1, n_leaves=2,
                           device=torch.device("cpu"))
    for s, perm in zip(port_api.score(model, ds), port_api.rank(model, ds)):
        assert np.array_equal(perm, np.argsort(-s, kind="stable"))
        assert len(set(s.tolist())) < len(s)          # ties are present


_ROUNDTRIP = {"0": ["-tree", "3", "-leaf", "3"], "1": ["-epoch", "2"],
              "2": ["-round", "5"], "3": ["-round", "5"],
              "4": ["-r", "1", "-i", "3"], "5": ["-epoch", "2"],
              "6": ["-tree", "3", "-leaf", "3"], "7": ["-epoch", "2"],
              "8": ["-bag", "2", "-leaf", "3"], "9": []}


@pytest.mark.parametrize("ranker", sorted(_ROUNDTRIP))
def test_model_files_roundtrip_both_ways(files, tmp_path, ranker):
    """ROADMAP item 4's criterion, for all ten rankers: each package's
    model file loads in the other, both packages save it again as the
    same bytes, and score it alike. (Both loaders keep only the model
    body of Coordinate Ascent, RankBoost, AdaRank and Random Forests
    files, so there a header hyperparameter that is not the default
    comes back as the default, in either package.)"""
    _, paths = files
    for name, main in (("ref", ref_main), ("port", port_main)):
        src = str(tmp_path / f"{name}.txt")
        assert main(["-train", paths["train"], "-ranker", ranker,
                     "-metric2t", "NDCG@10", "-silent", "-save", src,
                     *_ROUNDTRIP[ranker]]) == 0
        saved = []
        for load in (ref_load, port_load):
            again = str(tmp_path / f"{name}_again.txt")
            load(src).save(again)
            saved.append(open(again).read())
        assert saved[1] == saved[0]
        if ranker not in ("2", "3", "4", "8"):
            assert saved[1] == open(src).read()
        m_ref = ref_api.evaluate(ref_api.load(src), paths["test"])
        m_port = port_api.evaluate(port_api.load(src), paths["test"])
        assert m_port == pytest.approx(m_ref, abs=1e-5)
