"""The shared-grid ``-sparse -kcv`` (``RANKLIB_TPU_KCV_SHARED_GRID=1``, ref
evaluator.py:396-437) against the reference's, on the CPU.

Under the switch the training file is binned once (streamed, or from CSR
under ``-norm``) and every fold is rows of that one bin matrix
(``BinnedDataset.subset_queries``); by default each fold bins its own
training rows. With ``-tc 8`` and features of more than 8 distinct values
the two give other trees (tests/test_sparse_csr.py:611), so the fixture
shows which one ran:

* ``subset_queries`` is the reference's: the same queries, grid and rows;
* ``-ranker 6|0|8 -sparse -kcv 3`` under the switch, with and without
  ``-norm`` and ``-tvs`` and with ``-feature``: the reference's fold trees
  (structure and thresholds equal, leaf outputs to 1e-5, as every tree
  ranker's test holds them) and its printed lines;
* the switch bins once and the default bins each fold; the default's
  models are the dense pipeline's, the switch's are not.
"""

import contextlib
import io
import os

import numpy as np
import pytest

from ranklib_tpu.cli import main as ref_main
from ranklib_tpu.data import binned as RB
from ranklib_tpu.models.base import load_ranker_file as ref_load
from ranklib_tpu_torch.cli import main as port_main
from ranklib_tpu_torch.data import binned as PB
from ranklib_tpu_torch.models.base import load_ranker_file as port_load
from tests.fixtures import synth_dataset

SWITCH = "RANKLIB_TPU_KCV_SHARED_GRID"
TREE_FIELDS = ("feature", "threshold", "left", "right", "is_leaf")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("RANKLIB_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.delenv(SWITCH, raising=False)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A training file of 21 queries x 9 features, ~40% of the values left
    out (read as 0 under -missingZero), and a -feature file."""
    d = tmp_path_factory.mktemp("kcv_shared")
    rng = np.random.default_rng(17)
    ds = synth_dataset(n_queries=21, n_features=9, min_docs=5, max_docs=16,
                       gmax=2, seed=23, w_seed=3)
    out = {"train": str(d / "train.txt"), "feature": str(d / "f.txt")}
    with open(out["train"], "w") as f:
        for q in ds.queries:
            for i in range(q.n):
                keep = rng.random(q.feats.shape[1]) >= 0.4
                toks = " ".join(f"{j + 1}:{q.feats[i, j]:.6g}"
                                for j in range(q.feats.shape[1]) if keep[j])
                f.write(f"{int(q.labels[i])} qid:{q.qid} {toks} "
                        f"# d{q.qid}_{i}\n")
    with open(out["feature"], "w") as f:
        f.write("# five of nine\n1\n2\n4\n7\n9\n")
    return out


def _run(main, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(args)
    return rc, buf.getvalue()


def _lines(out):
    return [ln for ln in out.splitlines()
            if (" on " in ln and "data:" in ln)
            or ln.startswith(("Fold ", "Avg.", "bag "))]


def _ensembles(model):
    return model.ensembles if hasattr(model, "ensembles") else [
        model.ensemble]


def _kcv(main, files, out_dir, ranker, extra, sparse=True):
    rc, out = _run(main, ["-train", files["train"], "-ranker", ranker,
                          "-tree", "3", "-leaf", "3", "-bag", "2", "-tc",
                          "8", "-kcv", "3", "-metric2t", "NDCG@10",
                          "-missingZero", "-kcvmd", out_dir, "-kcvmn", "m",
                          *(["-sparse"] if sparse else []), *extra])
    assert rc == 0, out
    assert "not applicable" not in out
    return out, [os.path.join(out_dir, f"f{k}.m") for k in (1, 2, 3)]


@pytest.mark.parametrize("idxs", [[0, 1, 2], [5, 0, 17, 3], [20], []],
                         ids=["head", "shuffled", "last", "none"])
def test_subset_queries_matches_reference(files, idxs):
    """The port's BinnedDataset.subset_queries against the reference's
    (binned.py:54) on the same streamed file."""
    ref = RB.read_letor_binned(files["train"], n_threshold=8, quiet=True)
    port = PB.read_letor_binned(files["train"], n_threshold=8, quiet=True)
    a, b = ref.subset_queries(idxs), port.subset_queries(idxs)
    assert isinstance(b, PB.BinnedDataset)
    assert [q.qid for q in b.queries] == [q.qid for q in a.queries]
    for qa, qb in zip(a.queries, b.queries):
        np.testing.assert_array_equal(qb.labels, qa.labels)
    np.testing.assert_array_equal(b.thresholds, a.thresholds)
    np.testing.assert_array_equal(b.binned, a.binned)
    assert b.binned.dtype == a.binned.dtype and b.n_features == a.n_features


_FLOWS = {"plain": [], "norm": ["-norm", "zscore"], "tvs": ["-tvs", "0.7"],
          "norm-tvs": ["-norm", "linear", "-tvs", "0.6"],
          "feature": ["-feature", "{feature}"]}


@pytest.mark.parametrize("flow", list(_FLOWS))
@pytest.mark.parametrize("ranker", ["6", "0", "8"])
def test_shared_grid_kcv_matches_reference(files, tmp_path, monkeypatch,
                                           ranker, flow):
    """Under the switch: the reference's fold trees and printed lines."""
    monkeypatch.setenv(SWITCH, "1")
    extra = [a.format(**files) for a in _FLOWS[flow]]
    runs = {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        out, paths = _kcv(main, files, str(tmp_path / name), ranker, extra)
        runs[name] = (_lines(out), paths)
    assert runs["port"][0] == runs["ref"][0] and runs["ref"][0]
    for rp, pp in zip(runs["ref"][1], runs["port"][1]):
        want, got = _ensembles(ref_load(rp)), _ensembles(port_load(pp))
        assert len(got) == len(want)
        for a, b in zip(want, got):
            assert b.weights == a.weights and len(b.trees) == len(a.trees)
            for x, y in zip(a.trees, b.trees):
                for f in TREE_FIELDS:
                    np.testing.assert_array_equal(getattr(y, f),
                                                  getattr(x, f), f)
                np.testing.assert_allclose(y.output, x.output, rtol=1e-5,
                                           atol=1e-6)


@pytest.mark.parametrize("norm", [False, True], ids=["stream", "norm"])
def test_switch_bins_once_and_diverges_from_the_default(
        files, tmp_path, monkeypatch, norm):
    """tests/test_sparse_csr.py:611-637: the per-fold default bins each
    fold's training rows and saves the dense pipeline's models; the switch
    bins the file once (streamed, or one CSR binning under -norm) and,
    with -tc 8 below the features' distinct values, saves other ones."""
    from ranklib_tpu_torch import evaluator

    extra = ["-norm", "zscore"] if norm else []
    calls = []
    orig = PB.binned_from_csr
    monkeypatch.setattr(PB, "binned_from_csr", lambda *a, **k: (
        calls.append(1), orig(*a, **k))[1])
    texts = {}
    for tag, env, sparse in (("dense", None, False), ("fold", None, True),
                             ("shared", "1", True)):
        if env:
            monkeypatch.setenv(SWITCH, env)
        calls.clear()
        _, paths = _kcv(port_main, files, str(tmp_path / tag), "6", extra,
                        sparse)
        texts[tag] = [open(p).read() for p in paths]
        if tag == "fold":
            assert len(calls) == 6          # training and test, a fold
        if tag == "shared":
            assert len(calls) == (1 if norm else 0)
    assert evaluator.KCV_SHARED_GRID_ENV == SWITCH
    assert texts["fold"] == texts["dense"]
    assert texts["shared"] != texts["fold"]
