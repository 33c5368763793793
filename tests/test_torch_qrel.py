"""The port's external relevance judgments (``-qrel``) against the
reference's on the CPU: the same docids out of '#' descriptions, the same
labels after ``apply_qrel`` (unjudged documents 0), the same errors, and
the same printed lines where the CLI's train, k-fold, test and rank flows
read a qrel file."""

import numpy as np
import pytest

from ranklib_tpu.cli import main as ref_main
from ranklib_tpu.data.dataset import Dataset as RefDataset
from ranklib_tpu.data.dataset import Query as RefQuery
from ranklib_tpu.data.qrel import apply_qrel as ref_apply_qrel
from ranklib_tpu.data.qrel import doc_id as ref_doc_id
from ranklib_tpu.data.qrel import read_qrel as ref_read_qrel
from ranklib_tpu.utils.errors import RankLibError as RefRankLibError
from ranklib_tpu_torch.cli import main as port_main
from ranklib_tpu_torch.data.dataset import Dataset, Query
from ranklib_tpu_torch.data.qrel import apply_qrel, doc_id, read_qrel
from ranklib_tpu_torch.utils.errors import RankLibError
from tests.fixtures import synth_dataset, write_letor_text


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("RANKLIB_TPU_TORCH_DEVICE", "cpu")


DESCS = ["# docA", "#docid = GX1 inc = 1", "", "#", "# mydocid = GX1 docid = "
         "GX2", "# docidentifier GX8 rank = 2", "#DOCID=GX3",
         "# docid GX4 inc = 1", "#  spaced   out ", "# docid = GX008-86#p2"]


@pytest.mark.parametrize("desc", DESCS)
def test_doc_id_matches_reference(desc):
    assert doc_id(desc) == ref_doc_id(desc)


def _both(descs_per_query, labels_per_query):
    """The same queries in both packages' Dataset types."""
    out = []
    for Q, D in ((RefQuery, RefDataset), (Query, Dataset)):
        qs = [Q(str(i + 1), np.array(lab, np.float32),
                np.zeros((len(lab), 3), np.float32), list(descs))
              for i, (descs, lab) in enumerate(zip(descs_per_query,
                                                   labels_per_query))]
        out.append(D(qs, 3))
    return out


def test_apply_qrel_labels_match_reference(tmp_path):
    """Whole-comment and 'docid = X' forms; the word-boundary cases
    ('mydocid', 'docidentifier'); unjudged documents read 0; a judgment of
    an unseen document is ignored."""
    p = tmp_path / "q.qrel"
    p.write_text("# a comment line\n"
                 "1 0 docA 2\n1 0 docB 0\n2 0 GX1 3\n1 0 unseen 1\n"
                 "3 0 GX2 4\n3 0 GX1 1\n3 0 docidentifier 2\n3 Q0 GX3 1.5\n")
    ref, port = _both(
        [["# docA", "# docB", "# docC"], ["#docid = GX1 inc = 1"],
         ["# mydocid = GX1 docid = GX2", "# docidentifier GX8 rank = 2",
          "#DOCID=GX3", "# docid GX4 inc = 1"]],
        [[1, 1, 1], [0], [0, 0, 0, 2]])
    ref_apply_qrel(ref, str(p))
    apply_qrel(port, str(p))
    for a, b in zip(port.queries, ref.queries):
        np.testing.assert_array_equal(a.labels, b.labels)
    assert [list(q.labels) for q in port.queries] == [
        [2.0, 0.0, 0.0], [3.0], [4.0, 2.0, 1.5, 0.0]]
    assert read_qrel(str(p)) == ref_read_qrel(str(p))


@pytest.mark.parametrize("text,descs", [
    ("1 0 docA\n", [["# docA"]]),
    ("# only comments\n\n", [["# docA"]]),
    ("1 0 docA 1\n", [["# docA", ""]]),
    ("1 0 docA 1\n", [[]]),
], ids=["short-line", "no-judgments", "doc-without-desc", "no-descs"])
def test_errors_match_reference(tmp_path, text, descs):
    p = tmp_path / "bad.qrel"
    p.write_text(text)
    labels = [[0.0] * max(1, len(d)) for d in descs]
    ref, port = _both(descs, labels)
    with pytest.raises(RefRankLibError) as want:
        ref_apply_qrel(ref, str(p))
    with pytest.raises(RankLibError) as got:
        apply_qrel(port, str(p))
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """LETOR files whose '# doc<qid>_<i>' descriptions a qrel file judges
    with permuted labels (some documents left unjudged)."""
    d = tmp_path_factory.mktemp("torch_qrel")
    paths = {}
    rng = np.random.default_rng(5)
    lines = []
    for name, nq, seed in (("train", 12, 51), ("vali", 4, 52),
                           ("test", 6, 53)):
        ds = synth_dataset(n_queries=nq, n_features=5, seed=seed, w_seed=51,
                           signal=3.0)
        paths[name] = str(d / f"{name}.txt")
        write_letor_text(ds, paths[name])
        for q in ds.queries:
            perm = rng.permutation(q.labels)
            for i in range(q.n):
                if rng.random() < 0.9:
                    lines.append(f"{q.qid} 0 doc{q.qid}_{i} {int(perm[i])}")
    paths["qrel"] = str(d / "q.qrel")
    with open(paths["qrel"], "w") as f:
        f.write("\n".join(lines) + "\n")
    paths["model"] = str(d / "model.txt")
    assert ref_main(["-train", paths["train"], "-ranker", "9", "-save",
                     paths["model"]]) == 0
    return d, paths


def _lines(text):
    return [ln for ln in text.splitlines()
            if (" on " in ln and "data:" in ln) or ln.startswith(
                ("Relevance judgments", "Fold ", "Avg."))]


@pytest.mark.parametrize("flow", ["train", "kcv", "test", "rank"])
def test_cli_flows_with_qrel_match_reference(files, tmp_path, capsys, flow):
    _, p = files
    model = p["model"]
    capsys.readouterr()
    args = {
        "train": ["-train", p["train"], "-ranker", "4", "-r", "1", "-i",
                  "3", "-metric2t", "NDCG@5", "-validate", p["vali"],
                  "-test", p["test"], "-qrel", p["qrel"]],
        "kcv": ["-train", p["train"], "-ranker", "9", "-kcv", "3",
                "-qrel", p["qrel"]],
        "test": ["-load", model, "-test", p["test"], "-metric2T",
                 "NDCG@10", "-qrel", p["qrel"], "-idv", "IDV"],
        "rank": ["-load", model, "-rank", p["test"], "-qrel", p["qrel"],
                 "-score", "SCORE"],
    }[flow]
    out = {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        a = [str(tmp_path / f"{name}.{x.lower()}") if x in ("IDV", "SCORE")
             else x for x in args]
        assert main(a) == 0
        out[name] = _lines(capsys.readouterr().out)
    assert out["port"] == out["ref"]
    assert any(ln.startswith("Relevance judgments") for ln in out["port"])
    if flow == "test":
        assert (open(tmp_path / "port.idv").read()
                == open(tmp_path / "ref.idv").read())
    # the judgments changed the labels: without -qrel the lines differ
    if flow in ("train", "test"):
        plain = [x for x in args if x not in ("-qrel", p["qrel"])]
        plain = [str(tmp_path / "x") if x in ("IDV", "SCORE") else x
                 for x in plain]
        assert port_main(plain) == 0
        assert _lines(capsys.readouterr().out) != out["port"]
