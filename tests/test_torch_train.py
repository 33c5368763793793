"""The port's training path (LambdaMART/MART fit, the boosting round, the
``-train`` CLI flow) against the reference's on the CPU.

* One round from a mid-training reference state carried across with
  ``convert.boost_state_from_reference``: the next tree exactly equal,
  scores and metrics to rtol 1e-5 (no drift from earlier rounds).
* Whole fits: tree structures and thresholds identical to the
  reference's, leaf outputs to rtol 1e-5. Model files are not
  byte-identical: leaf outputs print at full f32 precision and their sums
  run in another order than XLA's.
* Early stop and best-round rollback land on the same rounds.
* The CLI prints the same metric lines; model files load across the two
  packages in both directions.
"""

import os

import jax
import numpy as np
import pytest
import torch

from ranklib_tpu.cli import main as ref_main
from ranklib_tpu.data.dataset import flatten as ref_flatten
from ranklib_tpu.gbdt import boost as RBoost
from ranklib_tpu.gbdt.binning import bin_features, compute_thresholds
from ranklib_tpu.metrics.base import create_scorer as ref_create_scorer
from ranklib_tpu.models.base import load_ranker_file as ref_load
from ranklib_tpu.models.gbdt import MART as RefMART
from ranklib_tpu.models.gbdt import LambdaMART as RefLambdaMART
from ranklib_tpu.models.gbdt import _pad_doc_count, _stop_round
from ranklib_tpu_torch.cli import main as port_main
from ranklib_tpu_torch.convert import boost_state_from_reference
from ranklib_tpu_torch.data.dataset import Dataset, Query
from ranklib_tpu_torch.gbdt import boost as PBoost
from ranklib_tpu_torch.metrics.base import create_scorer
from ranklib_tpu_torch.models import gbdt as PG
from ranklib_tpu_torch.models.base import load_ranker_file as port_load
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


def _port_ds(ds):
    return Dataset([Query(q.qid, q.labels.copy(), q.feats.copy(),
                          list(q.descs)) for q in ds.queries], ds.n_features)


def _data(seed=21, nq=12, val_nq=6):
    train = synth_dataset(n_queries=nq, n_features=6, min_docs=5,
                          max_docs=20, seed=seed, signal=3.0)
    val = synth_dataset(n_queries=val_nq, n_features=6, min_docs=5,
                        max_docs=20, seed=seed + 1, w_seed=seed, signal=3.0)
    return train, val


def _assert_same_trees(ref_ens, port_ens):
    assert len(port_ens.trees) == len(ref_ens.trees)
    assert port_ens.weights == ref_ens.weights
    for i, (a, b) in enumerate(zip(ref_ens.trees, port_ens.trees)):
        for f in TREE_FIELDS:
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f),
                                          err_msg=f"tree {i} {f}")
        np.testing.assert_allclose(b.output, a.output, rtol=1e-5, atol=1e-6,
                                   err_msg=f"tree {i} output")


def _fit_both(ref_cls, port_cls, metric, val=True, **hp):
    train, vali = _data()
    ref = ref_cls(**hp)
    ref.fit(train, ref_create_scorer(metric), vali if val else None)
    port = port_cls(**hp)
    port.fit(_port_ds(train), create_scorer(metric),
             _port_ds(vali) if val else None, device=CPU)
    return ref, port


@pytest.mark.parametrize("metric", ["NDCG@10", "ERR@10", "MAP"])
def test_lambdamart_fit_matches_reference(metric):
    ref, port = _fit_both(RefLambdaMART, PG.LambdaMART, metric, val=False,
                          n_trees=8, n_leaves=5, early_stop=0)
    _assert_same_trees(ref.ensemble, port.ensemble)
    np.testing.assert_allclose(port.feature_impacts, ref.feature_impacts,
                               rtol=1e-4)


def test_mart_fit_matches_reference():
    ref, port = _fit_both(RefMART, PG.MART, "NDCG@10", val=False,
                          n_trees=8, n_leaves=5, n_threshold=32)
    _assert_same_trees(ref.ensemble, port.ensemble)


def test_early_stop_and_rollback_rounds_match_reference(capsys):
    ref, port = _fit_both(RefLambdaMART, PG.LambdaMART, "NDCG@10",
                          n_trees=20, n_leaves=4, early_stop=3,
                          learning_rate=0.3)
    _assert_same_trees(ref.ensemble, port.ensemble)
    stops = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("Early stop")]
    assert len(stops) == 2 and stops[0] == stops[1]
    assert len(port.ensemble) < 20


def test_silent_fit_stops_on_the_same_round():
    """Silent mode reads the validation history only every few rounds;
    the replayed rule keeps the stop round and the model."""
    train, vali = _data()
    models = []
    for silent in (False, True):
        set_silent(silent)
        r = PG.LambdaMART(n_trees=20, n_leaves=4, early_stop=3,
                          learning_rate=0.3)
        r.fit(_port_ds(train), create_scorer("NDCG@10"), _port_ds(vali))
        models.append(r.model_str())
    assert models[0] == models[1]


@pytest.mark.parametrize("hist", [[0.5, 0.6, 0.6, 0.55, 0.59],
                                  [np.nan, 0.1, 0.2, 0.2, 0.2, 0.2],
                                  [0.3, 0.2, 0.1, 0.05]])
def test_stop_round_rule_matches_reference(hist):
    for estop in (1, 2, 3):
        assert PG._stop_round(np.array(hist), estop) == _stop_round(
            np.array(hist), estop)


def test_one_round_from_a_reference_state():
    """Run the reference three rounds, carry its state across, and take
    round 4 in both packages from that same state."""
    train, vali = _data(seed=31)
    rsc, psc = ref_create_scorer("NDCG@10"), create_scorer("NDCG@10")
    feats, labels, _ = ref_flatten(train)
    N, F = feats.shape
    thr, _ = compute_thresholds(feats, 256)
    Npad = _pad_doc_count(N)
    binned = bin_features(np.pad(feats, ((0, Npad - N), (0, 0))), thr)
    labels_pad = np.pad(labels, (0, Npad - N)).astype(np.float32)
    vbinned = bin_features(ref_flatten(vali)[0], thr)
    kw = dict(n_bins=thr.shape[1], n_leaves=5, min_leaf_support=1,
              learning_rate=0.1, pointwise=False, newton=True,
              n_queries=len(train.queries), n_vqueries=len(vali.queries))
    rdata, _, Nvpad = RBoost.make_boost_data(
        train, binned, labels_pad, N, vali, vbinned, scorer=rsc)
    rstep = RBoost.make_round_step(rsc, **kw)
    rstate = RBoost.init_state(10, 5, Npad, Nvpad, F)
    for t in range(3):
        rstate = rstep(rstate, t, rdata)
    pstate = boost_state_from_reference(jax.device_get(rstate), CPU)
    pdata, _, _ = PBoost.make_boost_data(
        _port_ds(train), binned, labels_pad, N, _port_ds(vali), vbinned, CPU,
        scorer=psc)
    pstep = PBoost.make_round_step(psc, **kw)
    want = jax.device_get(rstep(rstate, 3, rdata))
    got = pstep(pstate, 3, pdata)
    for f in ("tfeat", "tbin", "tleft", "tright", "tleaf", "tnodes"):
        np.testing.assert_array_equal(getattr(got, f)[3].numpy(),
                                      np.asarray(getattr(want, f)[3]))
    for f in ("tout", "scores", "vscores", "train_m", "val_m", "impacts"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(pdata.tb_inv.numpy(),
                                  np.asarray(rdata.tb_inv))
    assert pdata.binned_T.dtype == torch.uint8


def test_upload_bins_narrows_like_the_reference():
    a = np.array([[0, 255]], np.int32)
    assert PBoost.upload_bins(a, CPU).dtype == torch.uint8
    assert PBoost.upload_bins(a + 1, CPU).dtype == torch.int16
    assert PBoost.upload_bins(a + 40000, CPU).dtype == torch.int32
    assert PBoost.round_capacity(5) == 128
    assert PBoost.round_capacity(300) == 512


def test_leaf_one_is_rejected(tmp_path, capsys):
    with pytest.raises(RankLibError, match="-leaf must be >= 2"):
        PG.LambdaMART(n_leaves=1)
    with pytest.raises(RankLibError, match="unknown hyperparameter"):
        PG.MART(n_bags=3)
    train = tmp_path / "t.txt"
    write_letor_text(_data()[0], train)
    assert port_main(["-train", str(train), "-ranker", "6", "-leaf",
                      "1"]) == 1
    assert "Error: -leaf must be >= 2" in capsys.readouterr().out


# ---- the -train CLI flow ---------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_train")
    paths = {}
    for name, nq, seed in (("train", 14, 21), ("vali", 6, 22),
                           ("test", 6, 23)):
        paths[name] = str(d / f"{name}.txt")
        write_letor_text(synth_dataset(n_queries=nq, n_features=6,
                                       min_docs=5, max_docs=20, seed=seed,
                                       w_seed=21, signal=3.0),
                         paths[name])
    (d / "fids.txt").write_text("1\n2\n4\n6\n")
    paths["fids"] = str(d / "fids.txt")
    return d, paths


def _run_both(capsys, args, d, tag):
    out = {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        extra = ["-save", str(d / f"{tag}_{name}.txt")]
        if "-idv" in args:
            extra += ["-idv", str(d / f"{tag}_{name}.idv")]
        argv = [a for a in args if a != "-idv"] + extra
        assert main(argv) == 0
        out[name] = capsys.readouterr().out.splitlines()
    return out


def _split_lines(lines):
    """(result lines, per-round/impact numbers) of one CLI run."""
    results = [ln for ln in lines if " on " in ln and "data:" in ln]
    rows = [ln for ln in lines if ln[:1].isdigit() and "|" in ln]
    nums = [float(v) for ln in rows for v in ln.split("|")[1:]]
    impacts = [float(ln.split(":")[1]) for ln in lines
               if ln.startswith("  Feature ")]
    return results, nums, impacts


@pytest.mark.parametrize("args", [
    ["-ranker", "6", "-metric2t", "NDCG@10", "-validate", "{vali}",
     "-test", "{test}", "-metric2T", "ERR@10", "-idv", "-tree", "12",
     "-leaf", "5", "-estop", "4"],
    ["-ranker", "0", "-metric2t", "NDCG@5", "-tvs", "0.7", "-test",
     "{test}", "-tree", "8", "-leaf", "4", "-tc", "32"],
    ["-ranker", "6", "-metric2t", "MAP", "-tts", "0.7", "-tree", "6",
     "-leaf", "4", "-feature", "{fids}", "-shrinkage", "0.3", "-mls", "2"],
    ["-ranker", "6", "-metric2t", "ERR@10", "-tree", "6", "-leaf", "6",
     "-silent"],
], ids=["lambdamart-validate-test", "mart-tvs", "tts-feature-map",
        "silent-err"])
def test_train_flow_prints_the_reference_lines(files, capsys, args):
    d, paths = files
    args = ["-train", paths["train"]] + [a.format(**paths) for a in args]
    out = _run_both(capsys, args, d, tag=args[2] + args[4].replace("@", ""))
    ref, port = _split_lines(out["ref"]), _split_lines(out["port"])
    assert port[0] == ref[0] and len(ref[0]) >= 1
    np.testing.assert_allclose(port[1], ref[1], atol=1.5e-4)
    np.testing.assert_allclose(port[2], ref[2], rtol=1e-4)
    assert ("Training time:" in "\n".join(out["port"])) == ("-silent"
                                                           not in args)
    if "-idv" in args:
        tag = args[2] + args[4].replace("@", "")
        assert (open(d / f"{tag}_ref.idv").read()
                == open(d / f"{tag}_port.idv").read())


def test_trained_models_load_across_packages(files, capsys):
    d, paths = files
    _run_both(capsys, ["-train", paths["train"], "-ranker", "6",
                       "-metric2t", "NDCG@10", "-tree", "10", "-leaf", "5"],
              d, tag="cross")
    ref_model, port_model = d / "cross_ref.txt", d / "cross_port.txt"
    assert open(port_model).readline() == "## LambdaMART\n"
    # the port's model in the reference, and back: byte-identical text
    ref_load(str(port_model)).save(str(d / "port_in_ref.txt"))
    assert open(d / "port_in_ref.txt").read() == open(port_model).read()
    port_load(str(ref_model)).save(str(d / "ref_in_port.txt"))
    assert open(d / "ref_in_port.txt").read() == open(ref_model).read()
    # both packages score the port's model alike
    lines = {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        assert main(["-load", str(port_model), "-test", paths["test"],
                     "-metric2T", "NDCG@10"]) == 0
        lines[name] = capsys.readouterr().out.splitlines()[-1]
    assert lines["port"] == lines["ref"]


# -dp reaches every ranker: with RankBoost, -dp in every combination with
# the other flows and extensions (the cases keep their ids) exits as the
# reference's CLI does and prints its result lines; -resume and -ckpt are
# dropped for RankBoost, as there, and the fit still runs on the mesh
@pytest.mark.parametrize("extra,flag", [
    (["-kcv", "3", "-sparse", "-dp", "2"], "-dp"),
    (["-sparse", "-dp", "2"], "-dp"),
    (["-qrel", "q.txt", "-sparse", "-resume", "m.txt", "-dp", "2"], "-dp"),
    (["-norm", "zscore", "-sparse", "-ckpt", "5", "-dp", "3"], "-dp"),
    (["-resume", "m.txt", "-dp", "2"], "-dp"),
    (["-ckpt", "5", "-dp", "2"], "-dp"),
    (["-dp", "2"], "-dp"), (["-eventlog", "e.jsonl", "-dp", "2"], "-dp"),
    (["-profile", "trace", "-dp", "4"], "-dp"),
], ids=["extra0--kcv", "extra1--sparse", "extra2--qrel", "extra3--norm",
        "extra4--resume", "extra5--ckpt", "extra6--dp", "extra7--eventlog",
        "extra8--profile"])
def test_unported_training_flags_exit_1(files, capsys, extra, flag,
                                        tmp_path, monkeypatch):
    from ranklib_tpu_torch.parallel import dist

    _, paths = files
    monkeypatch.chdir(tmp_path)
    with open(paths["train"]) as f, open("q.txt", "w") as g:
        for i, line in enumerate(f):
            qid, doc = line.split()[1][4:], line.split("#")[1].strip()
            g.write(f"{qid} 0 {doc} {(i * 7) % 3}\n")
    meshes = []
    run = dist.run
    monkeypatch.setattr(dist, "run", lambda mesh, *a, **k: (
        meshes.append(mesh.size), run(mesh, *a, **k))[1])
    argv = ["-train", paths["train"], "-ranker", "2", "-round", "10",
            "-metric2t", "NDCG@10", *extra]
    lines = {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        assert main(argv) == 0
        lines[name] = [ln for ln in capsys.readouterr().out.splitlines()
                       if (" on " in ln and "data:" in ln)
                       or ln.startswith(("Fold ", "Avg.", "Relevance"))]
    assert lines["port"] == lines["ref"] and lines["port"]
    n_dp = int(extra[extra.index(flag) + 1])
    assert meshes == [n_dp] * (3 if "-kcv" in extra else 1)
    assert not os.path.exists("m.txt.ckpt") and not os.path.exists(
        "model.ckpt")


def test_other_rankers_are_not_ported(files, capsys):
    """All ten of RankLib's rankers are ported; a ranker id outside them
    exits 1 with the reference's error."""
    _, paths = files
    assert port_main(["-train", paths["train"], "-ranker", "11"]) == 1
    assert "Error: Unknown ranker type 11" in capsys.readouterr().out
