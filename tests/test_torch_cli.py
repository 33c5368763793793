"""The port's serving CLI (python -m ranklib_tpu_torch) against the
reference's on the same files.

A tiny LambdaMART model is trained once by ranklib_tpu on the CPU; both
packages then load it and run ``-load -test -idv`` and ``-load -rank
-score -indri``. Per-query values are compared parsed, to 1e-5 (the score
file prints %.6f, and f32 reassociation may move its last digit). Model
files round-trip byte for byte in both directions. A subprocess pins that
the port serves and trains with JAX unimportable and never loads the
reference.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ranklib_tpu.cli import main as ref_main
from ranklib_tpu.models.base import load_ranker_file as ref_load
from ranklib_tpu_torch.cli import main as port_main
from ranklib_tpu_torch.models.base import load_ranker_file as port_load
from tests.fixtures import synth_dataset, write_letor_text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """Hold the port's CPU path to the reference, card or not."""
    monkeypatch.setenv("RANKLIB_TPU_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    train, test = str(d / "train.txt"), str(d / "test.txt")
    write_letor_text(synth_dataset(n_queries=12, n_features=6, seed=21,
                                   signal=3.0), train)
    write_letor_text(synth_dataset(n_queries=9, n_features=6, seed=22,
                                   w_seed=21, signal=3.0), test)
    model = str(d / "model.txt")
    assert ref_main(["-train", train, "-ranker", "6", "-tree", "20",
                     "-leaf", "4", "-metric2t", "NDCG@10", "-silent",
                     "-save", model]) == 0
    return d, model, test


def _idv(path):
    rows = [line.split() for line in open(path)]
    return [r[1] for r in rows], np.array([float(r[2]) for r in rows])


def test_model_file_bytes_roundtrip_both_directions(files):
    d, model, _ = files
    text = open(model).read()
    assert text.startswith("## LambdaMART\n")
    port_load(model).save(str(d / "port_saved.txt"))
    assert open(d / "port_saved.txt").read() == text
    ref_load(str(d / "port_saved.txt")).save(str(d / "ref_again.txt"))
    assert open(d / "ref_again.txt").read() == text


@pytest.mark.parametrize("metric", ["NDCG@10", "ERR@5", "MAP", "P@3"])
def test_load_test_idv_matches_reference(files, metric, capsys):
    d, model, test = files
    tag = metric.replace("@", "")
    ref_idv, port_idv = str(d / f"ref_{tag}.idv"), str(d / f"port_{tag}.idv")
    assert ref_main(["-load", model, "-test", test, "-metric2T", metric,
                     "-idv", ref_idv]) == 0
    assert port_main(["-load", model, "-test", test, "-metric2T", metric,
                      "-idv", port_idv]) == 0
    out = capsys.readouterr().out
    assert f"{metric} on test data:" in out and "Device: cpu" in out
    ref_q, ref_v = _idv(ref_idv)
    port_q, port_v = _idv(port_idv)
    assert port_q == ref_q and port_q[-1] == "all"
    np.testing.assert_allclose(port_v, ref_v, atol=1e-5)


def test_load_rank_score_and_indri_match_reference(files):
    d, model, test = files
    outs = {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        sc, ind = str(d / f"{name}.score"), str(d / f"{name}.indri")
        assert main(["-load", model, "-rank", test, "-score", sc,
                     "-indri", ind]) == 0
        rows = [line.split("\t") for line in open(sc)]
        outs[name] = ([r[:2] for r in rows],
                      np.array([float(r[2]) for r in rows]),
                      [line.split()[:4] for line in open(ind)])
    assert outs["port"][0] == outs["ref"][0]
    np.testing.assert_allclose(outs["port"][1], outs["ref"][1], atol=1e-5)
    assert outs["port"][2] == outs["ref"][2]       # qid, Q0, docid, rank


def test_rank_without_outputs_prints_the_order(files, capsys):
    _, model, test = files
    assert ref_main(["-load", model, "-rank", test, "-silent"]) == 0
    want = capsys.readouterr().out
    assert port_main(["-load", model, "-rank", test, "-silent"]) == 0
    assert capsys.readouterr().out == want


def test_feature_subset_matches_reference(files):
    d, model, test = files
    feat = d / "features.txt"
    feat.write_text("# keep three\n1\n3\n5\n")
    for name, main in (("ref", ref_main), ("port", port_main)):
        assert main(["-load", model, "-test", test, "-feature", str(feat),
                     "-metric2T", "NDCG@10", "-idv",
                     str(d / f"{name}_feat.idv")]) == 0
    np.testing.assert_allclose(_idv(str(d / "port_feat.idv"))[1],
                               _idv(str(d / "ref_feat.idv"))[1], atol=1e-5)


@pytest.mark.parametrize("extra", [
    ["-train", "x.txt", "-resume", "m.txt"], ["-train", "x.txt", "-kcv", "3"],
    ["-sparse"], ["-qrel", "q.txt"], ["-norm", "zscore"], ["-ana"],
    ["-combine", "d"],
], ids=["train", "kcv", "sparse", "qrel", "norm", "ana", "combine"])
def test_unported_flows_exit_cleanly(files, extra, capsys):
    """-train itself is ported; the training flags that are not (here
    -resume and -kcv) still exit cleanly."""
    _, model, test = files
    rc = port_main(["-load", model, "-test", test, *extra])
    assert rc == 1
    flag = [a for a in extra if a.startswith("-")][-1]
    assert (f"Error: {flag} is not yet ported to ranklib_tpu_torch"
            in capsys.readouterr().out)


def test_errors_exit_1(files, tmp_path, capsys, monkeypatch):
    _, model, test = files
    assert port_main(["-test", test]) == 1                  # nothing to do
    other = tmp_path / "ranknet.txt"
    other.write_text("## RankNet\n")
    assert port_main(["-load", str(other), "-test", test]) == 1
    assert "not yet ported" in capsys.readouterr().out
    assert port_main(["-load", str(tmp_path / "missing.txt"), "-test",
                      test]) == 1
    monkeypatch.setenv("RANKLIB_TPU_TORCH_DEVICE", "cuda")
    if not torch.cuda.is_available():
        assert port_main(["-load", model, "-test", test]) == 1
        assert "CUDA is not available" in capsys.readouterr().out
    monkeypatch.setenv("RANKLIB_TPU_TORCH_DEVICE", "bogus")
    assert port_main(["-load", model, "-test", test]) == 1


def test_port_runs_without_jax_or_the_reference(files):
    d, model, test = files
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"          # any `import jax` now fails
        "from ranklib_tpu_torch.cli import main\n"
        f"rc = main(['-load', {model!r}, '-rank', {test!r}, '-score', "
        f"{str(d / 'nojax.score')!r}])\n"
        "assert rc == 0, rc\n"
        f"rc = main(['-train', {str(d / 'train.txt')!r}, '-ranker', '6', "
        f"'-tree', '3', '-leaf', '4', '-metric2t', 'NDCG@10', '-test', "
        f"{test!r}, '-save', {str(d / 'nojax_model.txt')!r}])\n"
        "assert rc == 0, rc\n"
        "assert sys.modules['jax'] is None\n"
        "bad = [m for m in sys.modules if m == 'ranklib_tpu' or "
        "m.startswith(('ranklib_tpu.', 'jax.', 'jaxlib'))]\n"
        "assert not bad, bad\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300, cwd=str(d))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")
    assert "NDCG@10 on training data:" in proc.stdout
    assert open(d / "nojax_model.txt").readline() == "## LambdaMART\n"
    assert port_main(["-load", model, "-rank", test, "-score",
                      str(d / "inproc.score")]) == 0
    np.testing.assert_array_equal(np.loadtxt(d / "nojax.score", usecols=2),
                                  np.loadtxt(d / "inproc.score", usecols=2))


def test_native_and_python_parsers_agree(files, monkeypatch):
    _, _, test = files
    from ranklib_tpu_torch.data import letor
    from ranklib_tpu_torch.native import loader

    native = letor.read_letor(test)
    monkeypatch.setattr(loader, "native_parse_letor", lambda path: None)
    python = letor.read_letor(test)
    assert native.n_features == python.n_features == 6
    for a, b in zip(native.queries, python.queries, strict=True):
        assert (a.qid, a.descs) == (b.qid, b.descs)
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.feats, b.feats)


def test_missing_features_need_missing_zero(tmp_path, files, capsys):
    _, model, _ = files
    sparse = tmp_path / "sparse.txt"
    sparse.write_text("2 qid:1 1:0.5 3:1.0 # a\n0 qid:1 1:0.1 2:0.2 3:0.3\n"
                      "1 qid:2 2:0.7 3:0.1\n")
    for main in (ref_main, port_main):
        assert main(["-load", model, "-test", str(sparse)]) == 1
        assert "-missingZero" in capsys.readouterr().out
        assert main(["-load", model, "-test", str(sparse),
                     "-missingZero"]) == 0
