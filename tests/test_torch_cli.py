"""The port's serving CLI (python -m ranklib_tpu_torch) against the
reference's on the same files.

A tiny LambdaMART model is trained once by ranklib_tpu on the CPU; both
packages then load it and run ``-load -test -idv`` and ``-load -rank
-score -indri``. Per-query values are compared parsed, to 1e-5 (the score
file prints %.6f, and f32 reassociation may move its last digit). Model
files round-trip byte for byte in both directions. ``-train`` of the
linear and boosting rankers — Coordinate Ascent with no ``-ranker``,
RankBoost, AdaRank, Linear Regression — under ``-norm`` prints the
reference's metric lines, and each saved model scores alike in the other
package. A subprocess pins that the port serves, trains (every ported
ranker, also with ``-qrel`` and ``-kcv``), trains and serves every
ranker's models with ``-sparse``, runs ``-ana`` and combines with JAX
unimportable and never loads the reference.
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
from ranklib_tpu_torch.utils.errors import RankLibError
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
    ["-train", "train.txt", "-r", "1", "-i", "4", "-resume", "m.txt", "-dp",
     "2"],
    ["-train", "train.txt", "-kcv", "3", "-r", "1", "-i", "4", "-sparse"],
    ["-train", "train.txt", "-ranker", "1", "-epoch", "5", "-sparse"],
    ["-train", "train.txt", "-ranker", "2", "-round", "20", "-qrel",
     "q.txt", "-sparse"],
    ["-train", "train.txt", "-ranker", "9", "-norm", "zscore", "-sparse"],
    ["-ana"], ["-combine", "d"],
], ids=["train", "kcv", "sparse", "qrel", "norm", "ana", "combine"])
def test_unported_flows_exit_cleanly(files, extra, capsys, monkeypatch):
    """Every training flow is ported: -dp with the default Coordinate
    Ascent (and -resume, which that ranker drops, as the reference does)
    runs in both CLIs and prints the same result lines. -sparse is ported
    for every ranker: with a raw-value ranker (here the default Coordinate
    Ascent under -kcv, RankNet, RankBoost with -qrel and Linear Regression
    with -norm) the same command line runs in both CLIs and prints the
    same result lines (RankNet from the reference's initial draws). -ana
    and -combine are ported, and without -all -base or -o exit with the
    reference's errors."""
    d, model, test = files
    if "-sparse" in extra or "-dp" in extra:
        import jax

        from ranklib_tpu.models import neural as RN
        from ranklib_tpu_torch.models import neural as PN

        monkeypatch.setattr(PN, "_init_params", lambda gen, sizes: [
            (np.asarray(W), np.asarray(b)) for W, b in RN._init_params(
                jax.random.PRNGKey(gen.initial_seed()), sizes)])
        qrel = d / "q.txt"
        with open(d / "train.txt") as f, open(qrel, "w") as g:
            for i, line in enumerate(f):
                qid, doc = line.split()[1][4:], line.split("#")[1].strip()
                g.write(f"{qid} 0 {doc} {(i * 7) % 3}\n")
        argv = ["-load", model, "-test", test, "-metric2t", "NDCG@10",
                *[str(d / a) if a.endswith(".txt") else a for a in extra]]
        lines = {}
        for name, main in (("ref", ref_main), ("port", port_main)):
            assert main(argv) == 0
            lines[name] = [ln for ln in capsys.readouterr().out.splitlines()
                           if (" on " in ln and "data:" in ln)
                           or ln.startswith(("Fold ", "Avg.", "Relevance"))]
        assert lines["port"] == lines["ref"]
        assert len(lines["port"]) >= (5 if "-kcv" in extra else 1)
        return
    rc = port_main(["-load", model, "-test", test, *extra])
    assert rc == 1
    flag = [a for a in extra if a.startswith("-")][-1]
    want = {"-ana": "Error: -ana requires -all <dir> and -base <file>",
            "-combine": "Error: -combine requires -o <output model file>",
            }[flag]
    assert want in capsys.readouterr().out


def _result_lines(text):
    return [ln for ln in text.splitlines() if " on " in ln and "data:" in ln]


@pytest.mark.parametrize("args", [
    ["-r", "2", "-i", "8"],
    ["-norm", "zscore", "-r", "2", "-i", "8", "-reg", "0.001"],
    ["-ranker", "2", "-norm", "sum", "-round", "30"],
    ["-ranker", "3", "-norm", "linear", "-round", "40"],
    ["-ranker", "9", "-norm", "zscore", "-L2", "0.1"],
], ids=["coorascent-default", "coorascent-zscore", "rankboost-sum",
        "adarank-linear", "linear-zscore"])
def test_linear_and_boosting_train_flows_match_reference(files, tmp_path,
                                                         capsys, args):
    """-train -validate -test -save with the same lines as the reference's
    (training, validation, test metrics); then each package's model
    scores the test file alike in the other package."""
    d, _, test = files
    vali = str(tmp_path / "vali.txt")
    write_letor_text(synth_dataset(n_queries=5, n_features=6, seed=23,
                                   w_seed=21, signal=3.0), vali)
    norm = args[args.index("-norm"):][:2] if "-norm" in args else []
    out, models = {}, {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        models[name] = str(tmp_path / f"{name}.txt")
        assert main(["-train", str(d / "train.txt"), "-metric2t", "NDCG@10",
                     "-validate", vali, "-test", test, *args,
                     "-save", models[name]]) == 0
        out[name] = _result_lines(capsys.readouterr().out)
    assert out["port"] == out["ref"] and len(out["ref"]) >= 3
    assert open(models["port"]).readline() == open(models["ref"]).readline()
    for model in models.values():
        lines = []
        for main in (ref_main, port_main):
            assert main(["-load", model, "-test", test, *norm,
                         "-metric2T", "NDCG@10"]) == 0
            lines.append(_result_lines(capsys.readouterr().out))
        assert lines[0] == lines[1] == [out["ref"][-1]]


def test_errors_exit_1(files, tmp_path, capsys, monkeypatch):
    _, model, test = files
    assert port_main(["-test", test]) == 1                  # nothing to do
    other = tmp_path / "ranknet.txt"
    other.write_text("## RankNet\n")
    assert port_main(["-load", str(other), "-test", test]) == 1
    assert "RankNet model missing 'Layer sizes'" in capsys.readouterr().out
    assert port_main(["-load", str(tmp_path / "missing.txt"), "-test",
                      test]) == 1
    monkeypatch.setenv("RANKLIB_TPU_TORCH_DEVICE", "cuda")
    if not torch.cuda.is_available():
        assert port_main(["-load", model, "-test", test]) == 1
        assert "CUDA is not available" in capsys.readouterr().out
    monkeypatch.setenv("RANKLIB_TPU_TORCH_DEVICE", "bogus")
    assert port_main(["-load", model, "-test", test]) == 1


def test_train_without_a_card_refuses(files, capsys, monkeypatch):
    """``-train`` with no CUDA device and no RANKLIB_TPU_TORCH_DEVICE exits 1
    with the device error before it reads anything; with the variable set
    to cpu the same command trains."""
    d, _, test = files
    monkeypatch.delenv("RANKLIB_TPU_TORCH_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["-train", str(d / "train.txt"), "-ranker", "6", "-tree",
            "2", "-leaf", "3", "-metric2t", "NDCG@5"]
    assert port_main(args) == 1
    out = capsys.readouterr().out
    assert "no CUDA device is available" in out
    assert "RANKLIB_TPU_TORCH_DEVICE=cpu" in out
    monkeypatch.setenv("RANKLIB_TPU_TORCH_DEVICE", "cpu")
    assert port_main(args) == 0
    assert "Device: cpu" in capsys.readouterr().out


def test_port_runs_without_jax_or_the_reference(files):
    d, model, test = files
    qrel = str(d / "nojax.qrel")
    with open(qrel, "w") as f:
        for line in open(test):
            qid, doc = line.split()[1][4:], line.split("#")[1].strip()
            f.write(f"{qid} 0 {doc} {int(line.split()[0]) % 3}\n")
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
        "import os\n"
        "os.environ['RANKLIB_TPU_FUSED_LAMBDA'] = '1'\n"
        f"rc = main(['-train', {str(d / 'train.txt')!r}, '-ranker', '6', "
        f"'-tree', '2', '-leaf', '4', '-metric2t', 'NDCG@10', '-silent', "
        f"'-save', {str(d / 'nojax_fused.txt')!r}])\n"
        "assert rc == 0, rc\n"
        "os.environ['RANKLIB_TPU_SERVE_SPLIT'] = '1'\n"
        f"rc = main(['-load', {model!r}, '-test', {test!r}])\n"
        "assert rc == 0, rc\n"
        "del os.environ['RANKLIB_TPU_FUSED_LAMBDA'], "
        "os.environ['RANKLIB_TPU_SERVE_SPLIT']\n"
        "import ranklib_tpu_torch.ops.lambda_kernel\n"
        "import ranklib_tpu_torch.tools.probes\n"
        f"os.makedirs({str(d / 'nojax_bags')!r}, exist_ok=True)\n"
        f"rc = main(['-train', {str(d / 'train.txt')!r}, '-ranker', '8', "
        f"'-bag', '2', '-leaf', '4', '-save', "
        f"{str(d / 'nojax_bags' / 'rf.txt')!r}])\n"
        "assert rc == 0, rc\n"
        f"rc = main(['-combine', {str(d / 'nojax_bags')!r}, '-o', "
        f"{str(d / 'nojax_combined.txt')!r}])\n"
        "assert rc == 0, rc\n"
        "for r in ('4', '2', '3', '9', '1', '5', '7'):\n"
        f"    m = os.path.join({str(d)!r}, 'nojax_' + r + '.txt')\n"
        f"    rc = main(['-train', {str(d / 'train.txt')!r}, '-ranker', r, "
        f"'-norm', 'zscore', '-r', '1', '-i', '4', '-round', '5', "
        f"'-epoch', '2', '-test', {test!r}, '-qrel', {qrel!r}, "
        f"'-save', m])\n"
        "    assert rc == 0, rc\n"
        f"    rc = main(['-load', m, '-test', {test!r}, '-norm', 'zscore'])\n"
        "    assert rc == 0, rc\n"
        f"rc = main(['-train', {str(d / 'train.txt')!r}, '-ranker', '1', "
        f"'-epoch', '1', '-kcv', '3', '-kcvmd', {str(d / 'nojax_kcv')!r}])\n"
        "assert rc == 0, rc\n"
        "for r in ('6', '0', '8'):\n"
        f"    m = os.path.join({str(d)!r}, 'nojax_sparse' + r + '.txt')\n"
        f"    for extra in ([], ['-norm', 'zscore'], ['-kcv', '2']):\n"
        f"        rc = main(['-train', {str(d / 'train.txt')!r}, '-ranker', "
        f"r, '-tree', '2', '-leaf', '3', '-bag', '2', '-sparse', '-save', "
        f"m, *extra])\n"
        "        assert rc == 0, rc\n"
        f"    rc = main(['-load', m, '-rank', {test!r}, '-sparse'])\n"
        "    assert rc == 0, rc\n"
        "for r in ('4', '2', '3', '9', '1', '5', '7'):\n"
        f"    m = os.path.join({str(d)!r}, 'nojax_sparse' + r + '.txt')\n"
        f"    rc = main(['-train', {str(d / 'train.txt')!r}, '-ranker', r, "
        f"'-r', '1', '-i', '3', '-round', '3', '-epoch', '1', '-sparse', "
        f"'-save', m])\n"
        "    assert rc == 0, rc\n"
        f"    rc = main(['-load', m, '-test', {test!r}, '-sparse'])\n"
        "    assert rc == 0, rc\n"
        f"os.makedirs({str(d / 'nojax_idv')!r}, exist_ok=True)\n"
        "for m in ('nojax_model.txt', 'nojax_4.txt', 'nojax_9.txt'):\n"
        f"    rc = main(['-load', os.path.join({str(d)!r}, m), '-test', "
        f"{test!r}, '-idv', os.path.join({str(d / 'nojax_idv')!r}, m)])\n"
        "    assert rc == 0, rc\n"
        f"rc = main(['-ana', '-all', {str(d / 'nojax_idv')!r}, '-base', "
        f"os.path.join({str(d / 'nojax_idv')!r}, 'nojax_model.txt'), "
        f"'-np', '500'])\n"
        "assert rc == 0, rc\n"
        "import ranklib_tpu_torch.api as rl\n"
        "import ranklib_tpu_torch.parallel.dist as dist\n"
        "import ranklib_tpu_torch.gbdt.boost_dist\n"
        "import ranklib_tpu_torch.parallel.dp\n"
        f"rc = main(['-train', {str(d / 'train.txt')!r}, '-ranker', '3', "
        f"'-round', '3', '-dp', '2'])\n"
        "assert rc == 0, rc\n"
        f"m = rl.train({str(d / 'train.txt')!r}, ranker=6, n_trees=2, "
        "n_leaves=3, device='cpu')\n"
        f"assert rl.evaluate(m, {test!r}, device='cpu') > 0\n"
        f"rc = main(['-train', {str(d / 'train.txt')!r}, '-ranker', '6', "
        f"'-tree', '2', '-leaf', '3', '-dp', '2', '-ckpt', '1', "
        f"'-eventlog', {str(d / 'nojax_ev.jsonl')!r}, '-save', "
        f"{str(d / 'nojax_dp.txt')!r}])\n"
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
    assert (open(d / "nojax_combined.txt").read(40)
            .startswith("## Random Forests\n## No. of bags = 2\n"))
    for r, name in (("1", "RankNet"), ("5", "LambdaRank"), ("7", "ListNet")):
        assert open(d / f"nojax_{r}.txt").readline() == f"## {name}\n"
    assert sorted(os.listdir(d / "nojax_kcv")) == ["f1.model", "f2.model",
                                                   "f3.model"]
    assert "Relevance judgments loaded from" in proc.stdout
    assert "(streamed to bins)" in proc.stdout
    assert "Detailed break down" in proc.stdout
    assert "not applicable" not in proc.stdout
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


def test_entry_points_default_to_the_card(monkeypatch):
    """``fit`` without a device takes the CLI's device rule: the card when
    one is present, unless RANKLIB_TPU_TORCH_DEVICE says otherwise; with no
    card and no variable it refuses to start (never a silent CPU run)."""
    from ranklib_tpu_torch import device as D
    from ranklib_tpu_torch.models import gbdt as PG
    from ranklib_tpu_torch.models import rf as PRF

    monkeypatch.delenv("RANKLIB_TPU_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert D.choose_device(quiet=True) == torch.device("cuda", 0)
    monkeypatch.setenv("RANKLIB_TPU_TORCH_DEVICE", "cpu")
    assert D.choose_device(quiet=True) == torch.device("cpu")
    monkeypatch.delenv("RANKLIB_TPU_TORCH_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RankLibError, match="RANKLIB_TPU_TORCH_DEVICE=cpu"):
        D.choose_device(quiet=True)
    monkeypatch.setenv("RANKLIB_TPU_TORCH_DEVICE", "cpu")
    assert D.choose_device(quiet=True) == torch.device("cpu")
    monkeypatch.delenv("RANKLIB_TPU_TORCH_DEVICE")
    seen = []
    for mod in (PG, PRF):
        monkeypatch.setattr(mod, "choose_device",
                            lambda quiet=False: seen.append(quiet)
                            or torch.device("cpu"))
    ds = synth_dataset(n_queries=4, n_features=3, seed=1)
    from ranklib_tpu_torch.data.dataset import Dataset, Query
    from ranklib_tpu_torch.metrics.base import create_scorer

    port_ds = Dataset([Query(q.qid, q.labels, q.feats, list(q.descs))
                       for q in ds.queries], ds.n_features)
    PG.LambdaMART(n_trees=1, n_leaves=2).fit(port_ds, create_scorer("NDCG@5"))
    PRF.RFRanker(n_bags=1, n_leaves=2).fit(port_ds, create_scorer("NDCG@5"))
    assert seen == [True, True]
