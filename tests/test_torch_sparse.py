"""``-sparse`` for the tree rankers: the port's streamed parse→bin loader
(``data/binned.py``), host CSR (``data/sparse.py``), ``to_bin_space`` and
the ``-sparse`` flows against the reference's and against the port's own
dense pipeline, on the CPU.

* Grids and bins: the streamed loader's equal the reference's and
  ``compute_thresholds``/``bin_features`` on the dense matrix (implicit
  zeros, negatives, -0.0 and ties, many uniques, duplicate fids where the
  last wins), also from ``.gz``; ``-missingZero`` and the no-relevant-doc
  rule raise as the reference does.
* CSR: the same arrays, lazy normalization, feature subsets, widths,
  query subsets and ``-tvs`` splits as the reference's and as the dense
  pipeline; chunked
  ``binned_from_csr`` grids equal to the dense ones.
* ``to_bin_space``: the reference's bin ids; off-grid thresholds raise.
* Models: ``-train -sparse`` with ``-ranker 6``, ``0`` and ``8`` (plain,
  ``-norm``, ``-tvs``, ``-tts``, ``-kcv 3``, ``-feature``, ``-qrel``,
  ``-validate -test``) writes the port's dense model byte for byte and the
  reference's ``-sparse`` trees (the same structure; leaf outputs within
  1e-5, as for dense fits) and prints its metric lines; ``-load -test`` and
  ``-load -rank -score -indri`` with ``-sparse`` print the reference's
  lines and write its files.
"""

import gzip
import io
import contextlib
import os

import numpy as np
import pytest
import torch

from ranklib_tpu.cli import main as ref_main
from ranklib_tpu.data import binned as RB
from ranklib_tpu.data import sparse as RS
from ranklib_tpu.data.cv import split_tvs as ref_split_tvs
from ranklib_tpu.data.letor import read_letor as ref_read_letor
from ranklib_tpu.gbdt.ensemble import TreeEnsemble as RefEnsemble
from ranklib_tpu.metrics.base import create_scorer as ref_create_scorer
from ranklib_tpu.models.base import load_ranker_file as ref_load
from ranklib_tpu.models.gbdt import LambdaMART as RefLambdaMART
from ranklib_tpu.utils.errors import RankLibError as RefRankLibError
from ranklib_tpu_torch.cli import main as port_main
from ranklib_tpu_torch.data import binned as PB
from ranklib_tpu_torch.data import sparse as PS
from ranklib_tpu_torch.data.cv import split_tvs
from ranklib_tpu_torch.data.dataset import flatten
from ranklib_tpu_torch.data.letor import read_letor
from ranklib_tpu_torch.data.normalize import normalize_dataset
from ranklib_tpu_torch.gbdt.binning import bin_features, compute_thresholds
from ranklib_tpu_torch.gbdt.ensemble import TreeEnsemble
from ranklib_tpu_torch.models.base import load_ranker_file as port_load
from ranklib_tpu_torch.utils.errors import RankLibError
from tests.fixtures import synth_dataset

CPU = torch.device("cpu")
TREE_FIELDS = ("feature", "threshold", "left", "right", "is_leaf")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("RANKLIB_TPU_TORCH_DEVICE", "cpu")


def _write_sparse(ds, path, rng, drop=0.5):
    """LETOR text with ~``drop`` of the (doc, fid) pairs left out (they
    read 0 under -missingZero) and a '#' docid a line."""
    with open(path, "w") as f:
        for q in ds.queries:
            for i in range(q.n):
                keep = rng.random(q.feats.shape[1]) >= drop
                toks = " ".join(f"{j + 1}:{q.feats[i, j]:.6g}"
                                for j in range(q.feats.shape[1]) if keep[j])
                f.write(f"{int(q.labels[i])} qid:{q.qid} {toks} "
                        f"# d{q.qid}_{i}\n")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_sparse")
    rng = np.random.default_rng(7)
    out = {"dir": d}
    for name, nq, seed in (("train", 20, 3), ("vali", 8, 4), ("test", 8, 5)):
        ds = synth_dataset(n_queries=nq, n_features=9, min_docs=5,
                           max_docs=18, gmax=2, seed=seed, w_seed=3)
        out[name] = str(d / f"{name}.txt")
        _write_sparse(ds, out[name], rng)
    out["qrel"] = str(d / "judgments.qrel")
    with open(out["train"]) as f, open(out["qrel"], "w") as g:
        for line in f:
            qid, doc = line.split()[1][4:], line.split("#")[1].strip()
            g.write(f"{qid} 0 {doc} {int(rng.integers(0, 3))}\n")
    out["feature"] = str(d / "features.txt")
    with open(out["feature"], "w") as f:
        f.write("# four of nine\n1\n3\n5\n8\n")
    return out


def _dense_grid(path, tc=256):
    feats = flatten(read_letor(path, missing_zero=True))[0]
    thr, _ = compute_thresholds(feats, tc)
    return thr, bin_features(feats, thr)


# ---- the streamed loader ------------------------------------------------------

_EDGE = ["2 qid:1 1:-1.5 2:3 4:7", "1 qid:1 1:-0.0 2:3", "0 qid:1 2:3 4:-2",
         "1 qid:2 1:2.25 4:7", "0 qid:2 1:-1.5"]
_DUP = ["1 qid:1 1:5.0 1:7.0 2:1.0", "0 qid:1 2:3.0",
        "2 qid:2 1:2.0 2:4.0 2:-1.0", "0 qid:2 1:2.0"]


@pytest.mark.parametrize("case", ["sparse", "edge", "many", "dup"])
def test_streamed_grid_and_bins_match_dense_and_reference(files, tmp_path,
                                                          case):
    tc = 256
    if case == "sparse":
        path = files["train"]
    else:
        path = str(tmp_path / f"{case}.txt")
        if case == "many":
            rng = np.random.default_rng(11)
            lines = [f"{i % 3} qid:{i // 30} 1:{rng.random():.9g} 2:{i}"
                     for i in range(300)]
            tc = 16
        else:
            lines = _EDGE if case == "edge" else _DUP
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
    thr, bins = _dense_grid(path, tc)
    got = PB.read_letor_binned(path, n_threshold=tc, quiet=True)
    want = RB.read_letor_binned(path, n_threshold=tc, quiet=True)
    assert isinstance(got, PB.BinnedDataset)
    assert got.binned.dtype == np.int16
    np.testing.assert_array_equal(got.thresholds, thr)
    np.testing.assert_array_equal(got.thresholds, want.thresholds)
    np.testing.assert_array_equal(got.binned.astype(np.int32), bins)
    np.testing.assert_array_equal(got.binned, want.binned)
    assert [q.qid for q in got.queries] == [q.qid for q in want.queries]
    assert all(q.feats is None for q in got.queries)
    for a, b in zip(got.queries, want.queries):
        np.testing.assert_array_equal(a.labels, b.labels)


def test_streamed_gzip_descs_and_split(files, tmp_path):
    gz = str(tmp_path / "train.txt.gz")
    with open(files["train"], "rb") as src, gzip.open(gz, "wb") as dst:
        dst.write(src.read())
    a = PB.read_letor_binned(files["train"], n_threshold=16, quiet=True,
                             want_descs=True)
    b = PB.read_letor_binned(gz, n_threshold=16, quiet=True,
                             want_descs=True)
    np.testing.assert_array_equal(a.binned, b.binned)
    np.testing.assert_array_equal(a.thresholds, b.thresholds)
    want = RB.read_letor_binned(gz, n_threshold=16, quiet=True,
                                want_descs=True)
    assert ([q.descs for q in b.queries] == [q.descs for q in a.queries]
            == [q.descs for q in want.queries])
    assert a.queries[0].descs[0] == "# d1_0"
    # -tvs/-tts with -sparse split the file's CSR (the grid is the
    # training side's), from .gz as from text
    csr = PS.read_letor_sparse(gz, quiet=True, want_descs=True)
    rcsr = RS.read_letor_sparse(gz, quiet=True, want_descs=True)
    for got, ref in zip(split_tvs(csr, 0.6), ref_split_tvs(rcsr, 0.6)):
        for x, y in zip(_csr_fields(got), _csr_fields(ref)):
            np.testing.assert_array_equal(np.asarray(x, dtype=object),
                                          np.asarray(y, dtype=object))
        np.testing.assert_array_equal(got.materialize_rows(0, got.n_docs),
                                      ref.materialize_rows(0, ref.n_docs))


def test_streamed_missing_zero_and_relevance_rules(tmp_path):
    gap = tmp_path / "gap.txt"
    gap.write_text("1 qid:1 1:1 2:2\n0 qid:1 1:3\n")
    with pytest.raises(RankLibError, match="missingZero"):
        PB.read_letor_binned(str(gap), missing_zero=False, quiet=True)
    with pytest.raises(RefRankLibError, match="missingZero"):
        RB.read_letor_binned(str(gap), missing_zero=False, quiet=True)
    assert PB.read_letor_binned(str(gap), quiet=True).binned.shape == (2, 2)
    rel = tmp_path / "rel.txt"
    rel.write_text("0 qid:1 1:1\n0 qid:1 1:2\n1 qid:2 1:3\n0 qid:2 1:4\n")
    with pytest.raises(RankLibError, match="dense pipeline"):
        PB.read_letor_binned(str(rel), must_have_rel_doc=True, quiet=True)
    grid = PB.read_letor_binned(str(rel), quiet=True).thresholds
    got = PB.read_letor_binned(str(rel), must_have_rel_doc=True,
                               thresholds=grid, quiet=True)
    want = RB.read_letor_binned(str(rel), must_have_rel_doc=True,
                                thresholds=grid, quiet=True)
    assert [q.qid for q in got.queries] == [q.qid for q in want.queries]
    np.testing.assert_array_equal(got.binned, want.binned)


# ---- host CSR -----------------------------------------------------------------

def _csr_fields(ds):
    return (ds.indptr, ds.fids, ds.vals, ds.qrow, ds.n_features,
            [q.qid for q in ds.queries], [list(q.descs) for q in ds.queries])


@pytest.mark.parametrize("norm", [None, "sum", "zscore", "linear"])
def test_csr_matches_reference_and_dense(files, norm):
    path = files["train"]
    got = PS.read_letor_sparse(path, quiet=True, want_descs=True)
    want = RS.read_letor_sparse(path, quiet=True, want_descs=True)
    for a, b in zip(_csr_fields(got), _csr_fields(want)):
        np.testing.assert_array_equal(np.asarray(a, dtype=object),
                                      np.asarray(b, dtype=object))
    dense = read_letor(path, missing_zero=True)
    if norm:
        got, want = PS.normalize_csr(got, norm), RS.normalize_csr(want, norm)
        normalize_dataset(dense, norm)
    for fids in (None, [1, 3, 8]):
        g, w = got, want
        if fids:
            g, w = g.subset_features(fids), w.subset_features(fids)
        for width in (None, 5, 12):
            gw = g.with_width(width) if width else g
            ww = w.with_width(width) if width else w
            np.testing.assert_array_equal(gw.materialize_rows(3, 40),
                                          ww.materialize_rows(3, 40))
    np.testing.assert_array_equal(got.materialize_rows(0, got.n_docs),
                                  flatten(dense)[0])
    # narrowing drops stored entries for good, as the dense clip does
    back = got.with_width(5).with_width(9)
    np.testing.assert_array_equal(back.materialize_rows(0, 20)[:, 5:], 0.0)
    sub, rsub = got.subset_queries([5, 1, 9]), want.subset_queries([5, 1, 9])
    np.testing.assert_array_equal(sub.materialize_rows(0, sub.n_docs),
                                  rsub.materialize_rows(0, rsub.n_docs))


def test_csr_python_parser_and_gzip_match_native(files, tmp_path,
                                                 monkeypatch):
    native = PS.read_letor_sparse(files["test"], quiet=True, want_descs=True)
    gz = str(tmp_path / "test.txt.gz")
    with open(files["test"], "rb") as src, gzip.open(gz, "wb") as dst:
        dst.write(src.read())
    from ranklib_tpu_torch.native import loader
    monkeypatch.setattr(loader, "native_parse_letor_csr", lambda p: None)
    for path in (files["test"], gz):
        py = PS.read_letor_sparse(path, quiet=True, want_descs=True)
        for a, b in zip(_csr_fields(py), _csr_fields(native)):
            np.testing.assert_array_equal(np.asarray(a, dtype=object),
                                          np.asarray(b, dtype=object))


@pytest.mark.parametrize("norm", [None, "zscore"])
def test_chunked_binned_from_csr_matches_dense_grid(files, monkeypatch,
                                                    norm):
    """Chunks of 17 rows (several per query) merge to the dense grid, at a
    -tc that puts some features over the cap and at 256."""
    ds = PS.read_letor_sparse(files["train"], quiet=True)
    ref = RS.read_letor_sparse(files["train"], quiet=True)
    dense = read_letor(files["train"], missing_zero=True)
    if norm:
        ds, ref = PS.normalize_csr(ds, norm), RS.normalize_csr(ref, norm)
        normalize_dataset(dense, norm)
    monkeypatch.setattr(PS, "_chunk_bytes", lambda: 17 * 9 * 4)
    monkeypatch.setattr(RS, "_chunk_bytes", lambda: 17 * 9 * 4)
    feats = flatten(dense)[0]
    for tc in (8, 256):
        got = PB.binned_from_csr(ds, n_threshold=tc)
        want = RB.binned_from_csr(ref, n_threshold=tc)
        thr, _ = compute_thresholds(feats, tc)
        np.testing.assert_array_equal(got.thresholds, thr)
        np.testing.assert_array_equal(got.thresholds, want.thresholds)
        np.testing.assert_array_equal(got.binned, want.binned)
        np.testing.assert_array_equal(got.binned,
                                      bin_features(feats, thr))


# ---- to_bin_space -------------------------------------------------------------

def test_to_bin_space_matches_reference_and_rejects_off_grid(files):
    ref = RefLambdaMART(n_trees=5, n_leaves=4)
    ref.fit(ref_read_letor(files["train"], missing_zero=True, quiet=True),
            ref_create_scorer("NDCG@10"))
    text = ref.ensemble.to_text()
    bd = PB.read_letor_binned(files["train"], quiet=True)
    got = TreeEnsemble.from_text(text).to_bin_space(bd.thresholds)
    want = RefEnsemble.from_text(text).to_bin_space(bd.thresholds)
    for a, b in zip(got.trees, want.trees):
        for f in (*TREE_FIELDS, "output"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert got.weights == want.weights
    flat = got.eval_matrix(bd.binned.astype(np.float32), CPU)
    dense = TreeEnsemble.from_text(text).eval_matrix(
        flatten(read_letor(files["train"], missing_zero=True))[0], CPU)
    np.testing.assert_array_equal(flat, dense)
    off = TreeEnsemble.from_text(text)
    node = int(np.flatnonzero(~off.trees[0].is_leaf)[0])
    off.trees[0].threshold[node] = np.nextafter(
        off.trees[0].threshold[node], np.float32(np.inf))
    with pytest.raises(RankLibError, match="off the binning grid"):
        off.to_bin_space(bd.thresholds)


# ---- the -sparse flows --------------------------------------------------------

def _run(main, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(args)
    return rc, buf.getvalue()


def _lines(out):
    return [ln for ln in out.splitlines()
            if (" on " in ln and "data:" in ln) or ln.startswith(
                ("Fold ", "Avg.", "bag ", "Train-test split"))]


def _ensembles(model):
    from ranklib_tpu.models.rf import RFRanker as RefRF
    return model.ensembles if isinstance(model, RefRF) else [model.ensemble]


def _assert_same_trees(ref_model, port_model):
    want = _ensembles(ref_model)
    got = (port_model.ensembles if hasattr(port_model, "ensembles")
           else [port_model.ensemble])
    assert len(got) == len(want)
    for e, (a, b) in enumerate(zip(want, got)):
        assert b.weights == a.weights and len(b.trees) == len(a.trees)
        for i, (x, y) in enumerate(zip(a.trees, b.trees)):
            for f in TREE_FIELDS:
                np.testing.assert_array_equal(getattr(y, f), getattr(x, f),
                                              err_msg=f"{e}/{i} {f}")
            np.testing.assert_allclose(y.output, x.output, rtol=1e-5,
                                       atol=1e-6, err_msg=f"{e}/{i} output")


_FLOWS = {
    "stream": ["-validate", "{vali}", "-test", "{test}"],
    "norm": ["-norm", "zscore", "-validate", "{vali}", "-test", "{test}"],
    "tvs": ["-tvs", "0.7", "-tc", "8"],
    "tts": ["-tts", "0.7", "-tc", "8", "-norm", "linear"],
    "kcv": ["-kcv", "3", "-kcvmd", "{out}", "-kcvmn", "m"],
    "feature-qrel": ["-feature", "{feature}", "-qrel", "{qrel}", "-test",
                     "{test}"],
}


@pytest.mark.parametrize("flow", list(_FLOWS))
@pytest.mark.parametrize("ranker", ["6", "0", "8"])
def test_sparse_train_matches_dense_and_reference(files, tmp_path, ranker,
                                                  flow):
    """Model file byte-equal to the port's dense fit's; the reference's
    -sparse trees; the reference's printed lines."""
    runs = {}
    for name, main, sparse in (("ref", ref_main, ["-sparse"]),
                               ("port", port_main, ["-sparse"]),
                               ("dense", port_main, [])):
        out_dir = str(tmp_path / name)
        extra = [a.format(out=out_dir, **{k: v for k, v in files.items()
                                          if k != "dir"})
                 for a in _FLOWS[flow]]
        model = str(tmp_path / f"{name}.txt")
        rc, out = _run(main, ["-train", files["train"], "-ranker", ranker,
                              "-tree", "4", "-leaf", "3", "-bag", "3",
                              "-metric2t", "NDCG@10", "-missingZero",
                              "-save", model, *extra, *sparse])
        assert rc == 0, out
        assert "not applicable" not in out
        paths = ([os.path.join(out_dir, f"f{k}.m") for k in (1, 2, 3)]
                 if flow == "kcv" else [model])
        runs[name] = (_lines(out), [open(p).read() for p in paths], paths)
    assert runs["port"][1] == runs["dense"][1]
    assert runs["port"][0] == runs["ref"][0] and runs["ref"][0]
    for ref_path, port_path in zip(runs["ref"][2], runs["port"][2]):
        _assert_same_trees(ref_load(ref_path), port_load(port_path))


def test_sparse_rf_console_bags_match_reference(files):
    """Non-silent Random Forests print each bag's train metric, scored in
    bin space on the streamed rows: the reference's lines."""
    lines = []
    for main in (ref_main, port_main):
        for rtype in ("0", "6"):
            rc, out = _run(main, ["-train", files["train"], "-ranker", "8",
                                  "-rtype", rtype, "-bag", "3", "-tree", "2",
                                  "-leaf", "3", "-metric2t", "NDCG@10",
                                  "-missingZero", "-sparse"])
            assert rc == 0, out
            lines.append([ln for ln in out.splitlines()
                          if ln.startswith("bag ")])
    assert lines[:2] == lines[2:] and len(lines[0]) == 3


@pytest.mark.parametrize("case", ["no-rel", "oversized"])
def test_sparse_fallback_to_dense_is_logged(tmp_path, case):
    """A query with no relevant document under MAP (the streamed grid
    would see its values), or a qid longer than the native parser's
    buffer: the loader bounces to the dense pipeline with the reference's
    log line, and the model equals the dense fit's."""
    rng = np.random.default_rng(11)
    ds = synth_dataset(n_queries=12, n_features=5, min_docs=5, max_docs=10,
                       gmax=2, seed=5)
    if case == "no-rel":
        ds.queries[3].labels[:] = 0.0
        ds.queries[3].feats[0, 2] = 99.0
    else:
        ds.queries[3].qid = "q" * 80
    path = str(tmp_path / "relcase.txt")
    _write_sparse(ds, path, rng, drop=0.3)
    texts = {}
    for tag, extra in (("dense", []), ("sparse", ["-sparse"])):
        model = str(tmp_path / f"{tag}.txt")
        rc, out = _run(port_main, ["-train", path, "-ranker", "6", "-tree",
                                   "3", "-leaf", "3", "-tc", "4",
                                   "-metric2t", "MAP", "-missingZero",
                                   "-save", model, *extra])
        assert rc == 0, out
        texts[tag] = open(model).read()
    assert "[-sparse] streaming loader not applicable" in out
    assert texts["dense"] == texts["sparse"]


@pytest.mark.parametrize("model_kind", ["lambdamart", "rf"])
def test_sparse_load_test_and_rank_match_reference(files, tmp_path,
                                                   model_kind):
    model = str(tmp_path / "model.txt")
    rank = ["-ranker", "8", "-bag", "2"] if model_kind == "rf" else []
    assert ref_main(["-train", files["train"], "-tree", "6", "-leaf", "4",
                     "-ranker", "6", *rank, "-missingZero", "-silent",
                     "-save", model]) == 0
    for flow in (["-test", files["test"], "-metric2T", "NDCG@10", "-idv",
                  "{n}.idv", "-qrel", files["qrel"]],
                 ["-rank", files["test"], "-score", "{n}.score", "-indri",
                  "{n}.indri"],
                 ["-test", files["test"], "-norm", "sum", "-feature",
                  files["feature"], "-metric2T", "ERR@5"]):
        outs = {}
        for name, main, sparse in (("ref", ref_main, ["-sparse"]),
                                   ("port", port_main, ["-sparse"]),
                                   ("dense", port_main, [])):
            args = [a.format(n=str(tmp_path / name)) for a in flow]
            rc, out = _run(main, ["-load", model, "-missingZero", *args,
                                  *sparse])
            assert rc == 0, out
            written = [open(a).read() for a in args if a.startswith(
                str(tmp_path))]
            outs[name] = (_lines(out), written)
        assert outs["port"] == outs["dense"]
        assert outs["port"][0] == outs["ref"][0]
        for got, want in zip(outs["port"][1], outs["ref"][1]):
            # idv and indri byte-equal here; the score column may move in
            # its last printed digit (f32 sums in another order, as dense)
            g = [ln.split() for ln in got.splitlines()]
            w = [ln.split() for ln in want.splitlines()]
            assert [r[:-2] for r in g] == [r[:-2] for r in w]
            np.testing.assert_allclose(
                [float(r[-1] if r[-1] != "indri" else r[-2]) for r in g],
                [float(r[-1] if r[-1] != "indri" else r[-2]) for r in w],
                atol=1e-5)


def test_sparse_load_of_a_raw_value_model_is_refused(files, tmp_path,
                                                     capsys):
    model = str(tmp_path / "lin.txt")
    assert port_main(["-train", files["train"], "-ranker", "9",
                      "-missingZero", "-silent", "-save", model]) == 0
    capsys.readouterr()
    assert port_main(["-load", model, "-test", files["test"],
                      "-missingZero", "-sparse"]) == 1
    assert ("-sparse with a loaded Linear Regression model is not yet "
            "ported" in capsys.readouterr().out)
