"""The port's k-fold cross validation (``-kcv``, ``-kcvmd``, ``-kcvmn``)
against the reference's on the CPU.

* ``prepare_cv`` puts the same queries (by qid) into each fold's train,
  validation and test sets, with and without ``-tvs``, and raises the
  same errors.
* ``-train -kcv``: Linear Regression and Coordinate Ascent print the
  reference's summary table line for line; LambdaMART's fold models have
  the reference's tree structures and score their test folds within 1e-6
  of it; every ``-kcvmd`` file loads in both packages.
"""

import os

import numpy as np
import pytest
import torch

from ranklib_tpu.cli import main as ref_main
from ranklib_tpu.data.cv import prepare_cv as ref_prepare_cv
from ranklib_tpu.data.letor import read_letor as ref_read_letor
from ranklib_tpu.metrics.base import create_scorer as ref_create_scorer
from ranklib_tpu.metrics.base import score_dataset as ref_score_dataset
from ranklib_tpu.models.base import load_ranker_file as ref_load
from ranklib_tpu.utils.errors import RankLibError as RefRankLibError
from ranklib_tpu_torch.cli import main as port_main
from ranklib_tpu_torch.data.cv import prepare_cv
from ranklib_tpu_torch.data.dataset import Dataset, Query
from ranklib_tpu_torch.data.letor import read_letor
from ranklib_tpu_torch.metrics.base import create_scorer, score_dataset
from ranklib_tpu_torch.models.base import load_ranker_file as port_load
from ranklib_tpu_torch.utils.errors import RankLibError
from tests.fixtures import synth_dataset, write_letor_text

CPU = torch.device("cpu")
TREE_FIELDS = ("feature", "threshold", "left", "right", "is_leaf")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("RANKLIB_TPU_TORCH_DEVICE", "cpu")


def _port_ds(ds):
    return Dataset([Query(q.qid, q.labels.copy(), q.feats.copy(),
                          list(q.descs)) for q in ds.queries], ds.n_features)


def _qids(ds):
    return None if ds is None else [q.qid for q in ds.queries]


@pytest.mark.parametrize("n_queries,k,tvs", [
    (10, 3, -1.0), (11, 4, -1.0), (7, 7, -1.0), (12, 3, 0.7), (9, 2, 0.5),
], ids=["10q-3f", "11q-4f", "7q-7f", "12q-3f-tvs", "9q-2f-tvs"])
@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
def test_fold_membership_matches_reference(n_queries, k, tvs, lazy):
    ds = synth_dataset(n_queries=n_queries, n_features=3, seed=n_queries)
    want = ref_prepare_cv(ds, k, tvs, lazy=lazy)
    got = prepare_cv(_port_ds(ds), k, tvs, lazy=lazy)
    assert isinstance(got, list) is (not lazy)
    want, got = list(want), list(got)
    assert len(got) == len(want) == k
    for (tr, va, te), (rtr, rva, rte) in zip(got, want):
        assert _qids(tr) == _qids(rtr)
        assert _qids(va) == _qids(rva)
        assert _qids(te) == _qids(rte)
        assert tr.n_features == te.n_features == 3
    tests = sorted(q for _, _, te in got for q in _qids(te))
    assert tests == sorted(q.qid for q in ds.queries)


@pytest.mark.parametrize("n_queries,k,tvs", [
    (5, 1, -1.0), (3, 4, -1.0), (6, 3, 0.1), (6, 3, 1.0),
], ids=["one-fold", "too-few-queries", "empty-train", "empty-validation"])
def test_fold_errors_match_reference(n_queries, k, tvs):
    ds = synth_dataset(n_queries=n_queries, n_features=3, seed=1)
    with pytest.raises(RefRankLibError) as want:
        ref_prepare_cv(ds, k, tvs)
    with pytest.raises(RankLibError) as got:
        prepare_cv(_port_ds(ds), k, tvs)
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def train_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cv")
    path = str(d / "train.txt")
    write_letor_text(synth_dataset(n_queries=15, n_features=6, min_docs=5,
                                   max_docs=20, seed=31, signal=3.0), path)
    return d, path


def _summary(text):
    lines = text.splitlines()
    return lines[lines.index("Summary:"):]


@pytest.mark.parametrize("args", [
    ["-ranker", "9"],
    ["-ranker", "4", "-r", "1", "-i", "2", "-norm", "zscore"],
    ["-ranker", "9", "-tvs", "0.8", "-metric2T", "ERR@5"],
], ids=["linear", "coorascent", "linear-tvs-err"])
def test_kcv_summary_matches_reference(train_file, capsys, args):
    d, path = train_file
    out = {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        assert main(["-train", path, "-kcv", "3", "-metric2t", "NDCG@10",
                     *args]) == 0
        out[name] = capsys.readouterr().out
    assert _summary(out["port"]) == _summary(out["ref"])
    assert len(_summary(out["port"])) == 2 + 3 + 1
    for fold in (1, 2, 3):
        assert f"Fold {fold} / 3..." in out["port"]


def test_kcv_lambdamart_folds_match_reference(train_file, capsys):
    """-ranker 6 -tree 5: per fold the same tree structures, fold metrics
    within 1e-6; each -kcvmd file loads in both packages."""
    d, path = train_file
    dirs = {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        dirs[name] = str(d / f"kcv_{name}")
        assert main(["-train", path, "-kcv", "3", "-ranker", "6", "-tree",
                     "5", "-leaf", "4", "-metric2t", "NDCG@10", "-metric2T",
                     "ERR@10", "-kcvmd", dirs[name], "-kcvmn", "lm",
                     "-silent"]) == 0
        out = capsys.readouterr().out
        assert "Summary:" in out
    for name in dirs:
        assert sorted(os.listdir(dirs[name])) == ["f1.lm", "f2.lm", "f3.lm"]
    folds = prepare_cv(read_letor(path), 3)
    ref_folds = ref_prepare_cv(ref_read_letor(path), 3)
    port_scorer, ref_scorer = create_scorer("ERR@10"), ref_create_scorer(
        "ERR@10")
    for f, ((_, _, te), (_, _, rte)) in enumerate(zip(folds, ref_folds)):
        files = {n: os.path.join(dirs[n], f"f{f + 1}.lm") for n in dirs}
        ref_model = ref_load(files["ref"])
        port_model = port_load(files["port"])
        assert len(port_model.ensemble) == len(ref_model.ensemble) == 5
        for a, b in zip(port_model.ensemble.trees, ref_model.ensemble.trees):
            for field in TREE_FIELDS:
                np.testing.assert_array_equal(getattr(a, field),
                                              getattr(b, field))
        m_port, _ = score_dataset(port_scorer, te,
                                  port_model.eval_dataset(te, CPU), CPU)
        m_ref, _ = ref_score_dataset(ref_scorer, rte,
                                     ref_model.eval_dataset(rte))
        assert abs(m_port - m_ref) <= 1e-6
        # each package's file loads in the other and scores the fold alike
        cross = port_load(files["ref"])
        m_cross, _ = score_dataset(port_scorer, te,
                                   cross.eval_dataset(te, CPU), CPU)
        assert abs(m_cross - m_ref) <= 1e-6
        back = ref_load(files["port"])
        m_back, _ = ref_score_dataset(ref_scorer, rte,
                                      back.eval_dataset(rte))
        assert abs(m_back - m_port) <= 1e-6


def test_kcv_model_names_and_errors(train_file, capsys, tmp_path):
    _, path = train_file
    md = str(tmp_path / "models")
    assert port_main(["-train", path, "-kcv", "2", "-ranker", "9",
                      "-kcvmd", md]) == 0
    assert sorted(os.listdir(md)) == ["f1.model", "f2.model"]
    assert open(os.path.join(md, "f1.model")).readline() == (
        "## Linear Regression\n")
    capsys.readouterr()
    assert port_main(["-train", path, "-kcv", "40", "-ranker", "9"]) == 1
    assert "Cannot make 40 folds from 15 queries" in capsys.readouterr().out
