"""The port's Random Forests (ranklib_tpu_torch.models.rf, with
data.sampling, gbdt.grow ``grow_forest``/``leaf_outputs_forest`` and the
combiner) against the reference's on the CPU.

* Bag sampling draws the same queries and features from the same seed.
* ``grow_forest``: every array of every bag's tree equal to the
  reference's; leaf outputs to rtol 1e-5 (f32 sums in another order).
* The ``-rtype 0`` fit's set-up: the fused pass (``bin_pad_T``) builds
  the old route's upload matrix, id for id and at its width; a dense fit
  takes it and a streamed ``-sparse`` fit the old route, each counted,
  with the old route's model.
* Whole fits, ``-rtype 0`` (lockstep groups) and ``-rtype 6`` (per-bag
  LambdaMART): trees bag for bag with the reference's structure and
  thresholds, outputs to rtol 1e-5; every bag also matches the float64
  oracle (``tools/oracle.py``) grown on the bag's resample. The model text
  does not depend on how bags are grouped.
* Model files load across the two packages in both directions; the
  ``-ranker 8`` and ``-combine`` CLI lines equal the reference's, and a
  combined model with more than 256 thresholds on a feature scores
  through the f32 route.
"""

import numpy as np
import pytest
import torch

from ranklib_tpu.cli import main as ref_main
from ranklib_tpu.data import sampling as RS
from ranklib_tpu.gbdt.grow import grow_forest as ref_grow_forest
from ranklib_tpu.gbdt.grow import leaf_outputs_forest as ref_leaf_outputs
from ranklib_tpu.metrics.base import create_scorer as ref_create_scorer
from ranklib_tpu.models.base import load_ranker_file as ref_load
from ranklib_tpu.models.rf import RFRanker as RefRF
from ltrbench.layer_metrics.program import Program
from ltrbench.trace import profiled
from ranklib_tpu_torch.cli import main as port_main
from ranklib_tpu_torch.convert import rf_from_reference
from ranklib_tpu_torch.data import sampling as PS
from ranklib_tpu_torch.data.binned import read_letor_binned
from ranklib_tpu_torch.data.dataset import Dataset, Query
from ranklib_tpu_torch.data.letor import read_letor
from ranklib_tpu_torch.gbdt import grow as PG
from ranklib_tpu_torch.gbdt.binning import compute_thresholds
from ranklib_tpu_torch.gbdt.boost import upload_bins
from ranklib_tpu_torch.gbdt.grow import grow_forest, leaf_outputs_forest
from ranklib_tpu_torch.metrics.base import create_scorer
from ranklib_tpu_torch.models import rf as PRF
from ranklib_tpu_torch.models.base import load_ranker_file as port_load
from ranklib_tpu_torch.models.gbdt import bin_pad_T, pad_binned
from ranklib_tpu_torch.utils.logging import set_silent
from tests.fixtures import synth_dataset, write_letor_text
from tests.test_oracle_parity import _tree_equal
from tools import oracle as orc

CPU = torch.device("cpu")
TREE_FIELDS = ("feature", "threshold", "left", "right", "is_leaf")
GROW_FIELDS = ("feature", "bin", "left", "right", "is_leaf", "n_nodes",
               "node_of_doc")


@pytest.fixture(autouse=True)
def _port_defaults(monkeypatch):
    monkeypatch.setenv("RANKLIB_TPU_TORCH_DEVICE", "cpu")
    set_silent(False)
    yield
    set_silent(False)


def _port_ds(ds):
    return Dataset([Query(q.qid, q.labels.copy(), q.feats.copy(),
                          list(q.descs)) for q in ds.queries], ds.n_features)


def _data(seed=5):
    return synth_dataset(n_queries=20, n_features=8, min_docs=8, max_docs=20,
                         seed=seed, w_seed=9, signal=3.0)


# ---- sampling --------------------------------------------------------------

@pytest.mark.parametrize("seed,srate,frate,repl", [
    (0, 1.0, 0.3, True), (7, 0.5, 0.8, True), (123, 0.3, 1.0, True),
    (5, 0.7, 0.01, False)])
def test_sampling_draws_like_the_reference(seed, srate, frate, repl):
    ref_ds = _data()
    port_ds = _port_ds(ref_ds)
    r_rng, p_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(4):
        r_s, r_oob, r_idx = RS.sample_queries(ref_ds, srate, r_rng, repl)
        p_s, p_oob, p_idx = PS.sample_queries(port_ds, srate, p_rng, repl)
        np.testing.assert_array_equal(p_idx, r_idx)
        assert [q.qid for q in p_s.queries] == [q.qid for q in r_s.queries]
        assert (p_oob is None) == (r_oob is None)
        if r_oob is not None:
            assert ([q.qid for q in p_oob.queries]
                    == [q.qid for q in r_oob.queries])
        assert (PS.sample_features(8, frate, p_rng)
                == RS.sample_features(8, frate, r_rng))


# ---- grow_forest / leaf_outputs_forest --------------------------------------

@pytest.mark.parametrize("Cb,B,dtype,weighted", [
    (5, 32, np.uint8, True), (1, 300, np.int16, False),
    (3, 256, np.int32, True)])
def test_grow_forest_matches_reference(Cb, B, dtype, weighted):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(B + Cb)
    F, N, L = 7, 600, 9
    binned = rng.integers(0, B, (F, N)).astype(dtype)
    binned[2] = rng.integers(0, 3, N)                   # few uniques
    grads = rng.normal(size=(Cb, N)).astype(np.float32)
    w = fm = None
    if weighted:
        w = rng.integers(0, 3, (Cb, N)).astype(np.float32)
        fm = rng.random((Cb, F)) > 0.4
        fm[:, 0] = True
    want = jax.device_get(ref_grow_forest(
        jnp.asarray(binned), jnp.asarray(grads), n_bins=B, n_leaves=L,
        doc_weights=None if w is None else jnp.asarray(w),
        feature_masks=None if fm is None else jnp.asarray(fm)))
    got = grow_forest(torch.from_numpy(binned), torch.from_numpy(grads), B,
                      L, 1, None if w is None else torch.from_numpy(w),
                      None if fm is None else torch.from_numpy(fm))
    for f in GROW_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.impacts.numpy(), np.asarray(want.impacts),
                               rtol=1e-4, atol=1e-4)
    lam = rng.normal(size=(Cb, N)).astype(np.float32)
    hess = rng.random((Cb, N)).astype(np.float32) + 0.1
    for newton in (False, True):
        ref_out = np.asarray(ref_leaf_outputs(
            jnp.asarray(want.node_of_doc), jnp.asarray(lam),
            jnp.asarray(hess), 2 * L - 1, newton,
            None if w is None else jnp.asarray(w)))
        out = leaf_outputs_forest(got.node_of_doc, torch.from_numpy(lam),
                                  torch.from_numpy(hess), 2 * L - 1, newton,
                                  None if w is None else torch.from_numpy(w))
        np.testing.assert_allclose(out.numpy(), ref_out, rtol=1e-5,
                                   atol=1e-6)


def test_leaf_outputs_forest_chunks_bags(monkeypatch):
    """Fewer bags per masked temporary than the group: the same values."""
    rng = np.random.default_rng(1)
    node = torch.from_numpy(rng.integers(0, 7, (5, 90)).astype(np.int32))
    lam = torch.from_numpy(rng.normal(size=(5, 90)).astype(np.float32))
    w = torch.from_numpy(rng.integers(0, 3, (5, 90)).astype(np.float32))
    whole = leaf_outputs_forest(node, lam, lam, 7, False, w)
    monkeypatch.setattr(PG, "_LEAF_BUDGET", 7 * 90 * 2)     # 2 bags a pass
    torch.testing.assert_close(leaf_outputs_forest(node, lam, lam, 7, False,
                                                   w), whole, atol=0, rtol=0)


@pytest.mark.parametrize("B,dtype", [(32, np.uint8), (300, np.int16)])
def test_grow_forest_feature_lists_change_no_tree(B, dtype):
    """-frate 0.3: the histograms of each bag's sampled features alone
    (the rest zero) grow every bag's tree of the list-free growth."""
    from ranklib_tpu_torch.ops.histogram import feature_lists

    rng = np.random.default_rng(B)
    F, N, L, Cb = 20, 600, 9, 4
    binned = torch.from_numpy(rng.integers(0, B, (F, N)).astype(dtype))
    grads = torch.from_numpy(rng.normal(size=(Cb, N)).astype(np.float32))
    w = torch.from_numpy(rng.integers(0, 3, (Cb, N)).astype(np.float32))
    fm = np.zeros((Cb, F), bool)
    for c in range(Cb):
        fm[c, [f - 1 for f in PS.sample_features(F, 0.3, rng)]] = True
    lists = torch.from_numpy(feature_lists(fm))
    assert lists.shape == (Cb, 6)
    fmask = torch.from_numpy(fm)
    want = grow_forest(binned, grads, B, L, 1, w, fmask)
    got = grow_forest(binned, grads, B, L, 1, w, fmask, lists)
    for f in GROW_FIELDS + ("impacts",):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f).numpy(), err_msg=f)


def test_rf_fit_passes_feature_lists_and_keeps_its_model(monkeypatch):
    """A -rtype 0 fit at -frate 0.3 hands each group step its bags'
    feature lists (int(0.3 F) entries each), and saves the model of the
    same fit whose group steps drop them."""
    ds = _port_ds(_data(seed=8))
    scorer = create_scorer("NDCG@10")
    hp = dict(n_bags=5, n_leaves=6, feature_sampling_rate=0.3, seed=3)
    step = PRF.group_step
    widths = []

    def listless(*args):
        widths.append(tuple(args[8].shape))
        return step(*args[:8])

    fits = []
    for patch in (False, True):
        if patch:
            monkeypatch.setattr(PRF, "group_step", listless)
        rf = PRF.RFRanker(**hp)
        set_silent(True)
        rf.fit(ds, scorer, device=CPU)
        fits.append(rf.model_str())
    assert widths == [(5, 2)]
    assert fits[0] == fits[1]


# ---- the fit's set-up ---------------------------------------------------------

def _setup_feats(case: str):
    """(feats [N, F] f32, -tc, the width the old route uploads)."""
    rng = np.random.default_rng(17)
    if case == "u8":                            # B = 128
        return rng.normal(size=(300, 5)).astype(np.float32), 16, np.uint8
    x = rng.normal(size=(1000, 5)).astype(np.float32)  # B = 256
    if case == "nan":
        x[::7, 2] = np.nan                      # NaN bins to B
        return x, 256, np.int16
    x[:, 3] = -1 - rng.random(1000)             # 256 thresholds below 0
    if case == "pad_256":
        return x, 256, np.int16                 # a pad doc bins to 256
    return x[:512], 256, np.uint8               # no pad docs


@pytest.mark.parametrize("case", ["u8", "nan", "pad_256", "no_pad"])
def test_bin_pad_T_builds_the_old_routes_matrix(case):
    feats, tc, width = _setup_feats(case)
    N = len(feats)
    thr, _ = compute_thresholds(feats, tc)
    labels = np.arange(N, dtype=np.float32) % 5
    binned, labels_old, Npad_old = pad_binned(feats, None, thr, labels, N)
    old = upload_bins(np.ascontiguousarray(binned.T), CPU).numpy()
    ids, labels_pad, Npad = bin_pad_T(feats, thr, labels, N)
    assert ids.dtype == old.dtype == width
    assert ids.shape == (feats.shape[1], Npad) and ids.flags.c_contiguous
    np.testing.assert_array_equal(ids, old)
    np.testing.assert_array_equal(labels_pad, labels_old)
    assert labels_pad.dtype == np.float32
    assert Npad == Npad_old and (Npad > N) == (case != "no_pad")


@pytest.mark.parametrize("route", ["dense", "streamed"])
def test_rf_setup_route_is_counted_and_keeps_the_model(tmp_path, monkeypatch,
                                                       route):
    """A dense -rtype 0 fit takes the fused pass (``fit.bin_T``, no
    ``fit.pad`` or ``fit.transpose``), a streamed -sparse fit the old
    route; ``bin_pad_T`` counts each. Either model is byte-equal to the
    old route's on the dense data."""
    path = str(tmp_path / "train.txt")
    write_letor_text(_data(), path)
    dense = read_letor(path)
    ds = dense if route == "dense" else read_letor_binned(path)
    hp = dict(n_bags=4, n_leaves=5, feature_sampling_rate=0.5, seed=4)
    scorer = create_scorer("NDCG@10")
    set_silent(True)
    before = bin_pad_T.fused, bin_pad_T.fallback
    rf = PRF.RFRanker(**hp)
    with profiled(cuda=False) as box:
        rf.fit(ds, scorer, device=CPU)
    fused = route == "dense"
    assert (bin_pad_T.fused - before[0],
            bin_pad_T.fallback - before[1]) == ((1, 0) if fused else (0, 1))
    p = Program(box["trace"])
    assert p.count("fit.bin_T") == 1
    for name in ("fit.pad", "fit.transpose"):
        assert p.count(name) == (0 if fused else 1), name
    monkeypatch.setattr(PRF, "bin_pad_T", lambda *a: None)   # the old route
    old = PRF.RFRanker(**hp)
    old.fit(dense, scorer, device=CPU)
    assert rf.model_str() == old.model_str()


# ---- whole fits ---------------------------------------------------------------

def _assert_same_bags(ref_rf, port_rf):
    assert len(port_rf.ensembles) == len(ref_rf.ensembles)
    for b, (ra, pa) in enumerate(zip(ref_rf.ensembles, port_rf.ensembles)):
        assert pa.weights == ra.weights
        assert len(pa.trees) == len(ra.trees)
        for i, (x, y) in enumerate(zip(ra.trees, pa.trees)):
            for f in TREE_FIELDS:
                np.testing.assert_array_equal(getattr(y, f), getattr(x, f),
                                              err_msg=f"bag {b} tree {i} {f}")
            np.testing.assert_allclose(y.output, x.output, rtol=1e-5,
                                       atol=1e-6,
                                       err_msg=f"bag {b} tree {i} output")


@pytest.mark.parametrize("rtype", [0, 6])
def test_rf_fit_matches_reference_bag_for_bag(rtype):
    train = _data()
    hp = dict(n_bags=5, n_trees=2, n_leaves=6, feature_sampling_rate=0.5,
              seed=3, ranker_type=rtype)
    ref = RefRF(**hp)
    ref.fit(train, ref_create_scorer("NDCG@10"))
    port = PRF.RFRanker(**hp)
    port.fit(_port_ds(train), create_scorer("NDCG@10"))
    _assert_same_bags(ref, port)


def test_rf_bag_oracle_parity():
    """Mirror of tests/test_oracle_parity_all.py:244: every bag's trees
    match an oracle MART grown on the bag's materialized resample."""
    from ranklib_tpu_torch.data.dataset import flatten

    ds = _port_ds(synth_dataset(n_queries=10, n_features=6, min_docs=5,
                                max_docs=12, gmax=2, seed=151))
    eng = PRF.RFRanker(n_bags=3, n_trees=2, n_leaves=4, seed=7,
                       feature_sampling_rate=0.5, n_threshold=16)
    eng.fit(ds, create_scorer("NDCG@10"))
    feats, _, _ = flatten(ds)
    thr_o = orc.compute_thresholds_oracle(feats, 16)
    rng = np.random.default_rng(7)
    for bag in range(3):
        _, _, qidx = PS.sample_queries(ds, 1.0, rng)
        fids = PS.sample_features(6, 0.5, rng)
        fmask = np.zeros(6, bool)
        fmask[[f - 1 for f in fids]] = True
        o = orc.OracleLambdaMART(
            n_trees=2, n_leaves=4, learning_rate=0.1, n_threshold=16,
            min_leaf_support=1.0, early_stop=0, metric="NDCG", k=10,
            pointwise=True, newton=False)
        o.fit([orc.dataset_to_oracle(ds)[i] for i in qidx],
              feature_mask=fmask, thresholds=thr_o)
        ens = eng.ensembles[bag]
        assert len(ens.trees) == len(o.trees)
        for te, to in zip(ens.trees, o.trees):
            _tree_equal(te, to, thr_o)


def test_model_does_not_depend_on_the_grouping(monkeypatch):
    train = _port_ds(_data())
    hp = dict(n_bags=6, n_trees=2, n_leaves=5, seed=11,
              feature_sampling_rate=0.5)
    texts = []
    for size in (None, 4, 2):
        if size is not None:
            monkeypatch.setattr(PRF, "bag_group_size",
                                lambda *args, s=size: s)
        r = PRF.RFRanker(**hp)
        r.fit(train, create_scorer("NDCG@10"))
        texts.append(r.model_str())
    assert texts[0] == texts[1] == texts[2]


def test_bag_group_size_rounds_to_the_kernel_bag_tile():
    # RF defaults at the bench's width: ~67.7 MB a bag, 2 GiB on the CPU;
    # the kernel takes one bag a block, so no rounding is left
    assert PRF.bag_group_size(199, 136, 256, 180224, 300, CPU) == 31
    assert PRF.bag_group_size(199, 136, 256, 180224, 5, CPU) == 5
    assert PRF.bag_group_size(19, 6, 32, 256, 300, CPU) == 300
    assert PRF.bag_group_size(10**6, 136, 256, 10**6, 300, CPU) == 1


# ---- model files and the CLI ------------------------------------------------

def test_model_text_roundtrips_between_packages(tmp_path):
    """A forest saved by either package loads in both, and both then save
    the same text (loading keeps the bags and their count; like the
    reference, the other header values return to their defaults), whose
    <ensemble> blocks are the saved file's, byte for byte."""
    train = _data()
    ref = RefRF(n_bags=3, n_trees=2, n_leaves=5, seed=2)
    ref.fit(train, ref_create_scorer("NDCG@10"))
    port = PRF.RFRanker(n_bags=3, n_trees=2, n_leaves=5, seed=2)
    port.fit(_port_ds(train), create_scorer("NDCG@10"))
    for name, model in (("ref", ref), ("port", port)):
        path = str(tmp_path / f"{name}.txt")
        model.save(path)
        text = open(path).read()
        in_ref, in_port = ref_load(path).model_str(), port_load(path).model_str()
        assert in_port == in_ref
        body = text[text.index("<ensemble>"):]
        assert in_port[in_port.index("<ensemble>"):] == body
        assert text.count("<ensemble>") == 3
    # one forest scored by both packages
    carried = rf_from_reference(ref)
    assert carried.model_str() == ref.model_str()
    test = _data(seed=6)
    for a, b in zip(carried.eval_dataset(_port_ds(test), CPU),
                    ref.eval_dataset(test)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_rf")
    paths = {}
    for name, seed in (("train", 21), ("vali", 22), ("test", 23)):
        paths[name] = str(d / f"{name}.txt")
        write_letor_text(synth_dataset(n_queries=14, n_features=6,
                                       min_docs=5, max_docs=20, seed=seed,
                                       w_seed=21, signal=3.0), paths[name])
    return d, paths


def _lines(lines):
    """Result and per-bag lines of one CLI run (timing lines dropped)."""
    return [ln for ln in lines if (" on " in ln and "data:" in ln)
            or ln.startswith("bag ") or ln.startswith("Error")]


@pytest.mark.parametrize("args", [
    ["-rtype", "0", "-bag", "4", "-leaf", "5", "-frate", "0.5",
     "-validate", "{vali}", "-test", "{test}", "-metric2T", "ERR@10",
     "-idv"],
    ["-rtype", "6", "-bag", "3", "-tree", "2", "-leaf", "4", "-srate",
     "0.8", "-shrinkage", "0.3", "-tc", "16", "-randomSeed", "5", "-test",
     "{test}"],
], ids=["rtype0-validate-test", "rtype6-seed"])
def test_rf_cli_prints_the_reference_lines(files, capsys, args):
    d, paths = files
    tag = args[1]
    out, models = {}, {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        models[name] = str(d / f"rf{tag}_{name}.txt")
        argv = ["-train", paths["train"], "-ranker", "8", "-metric2t",
                "NDCG@10", *[a.format(**paths) for a in args if a != "-idv"],
                "-save", models[name]]
        if "-idv" in args:
            argv += ["-idv", str(d / f"rf{tag}_{name}.idv")]
        assert main(argv) == 0
        out[name] = _lines(capsys.readouterr().out.splitlines())
    assert out["port"] == out["ref"] and len(out["ref"]) >= 4
    assert open(models["port"]).readline() == "## Random Forests\n"
    if "-idv" in args:
        assert (open(d / f"rf{tag}_ref.idv").read()
                == open(d / f"rf{tag}_port.idv").read())
    lines = {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        assert main(["-load", models["port"], "-test", paths["test"],
                     "-metric2T", "NDCG@10"]) == 0
        lines[name] = capsys.readouterr().out.splitlines()[-1]
    assert lines["port"] == lines["ref"]


@pytest.mark.parametrize("extra,msg", [
    (["-mls", "2"], "unknown hyperparameter 'min_leaf_support'"),
    (["-rtype", "3"], "supports -rtype 0 (MART) or 6"),
], ids=["mls", "rtype"])
def test_rf_cli_errors_like_the_reference(files, capsys, extra, msg):
    _, paths = files
    for main in (ref_main, port_main):
        assert main(["-train", paths["train"], "-ranker", "8", *extra]) == 1
        assert msg in capsys.readouterr().out


def test_combine_cli_matches_reference_and_serves_through_f32(files,
                                                              tmp_path,
                                                              capsys):
    """Three forests trained on different files: their union has more
    than 256 thresholds on a feature, so the combined model scores on the
    f32 route. Both packages write the same file and print the same
    lines."""
    _, paths = files
    bags = tmp_path / "bags"
    bags.mkdir()
    for i in range(3):
        data = tmp_path / f"d{i}.txt"
        write_letor_text(synth_dataset(n_queries=30, n_features=2,
                                       min_docs=15, max_docs=25, seed=40 + i,
                                       w_seed=41, signal=3.0), data)
        assert ref_main(["-train", str(data), "-ranker", "8", "-bag", "6",
                         "-leaf", "80", "-frate", "1.0", "-silent",
                         "-save", str(bags / f"rf{i}.txt")]) == 0
    (bags / "notes.txt").write_text("no model here\n")
    capsys.readouterr()
    out = {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        assert main(["-combine", str(bags), "-o",
                     str(tmp_path / f"comb_{name}.txt")]) == 0
        out[name] = capsys.readouterr().out.replace(
            str(tmp_path / f"comb_{name}.txt"), "OUT")
    assert out["port"] == out["ref"]
    text = (tmp_path / "comb_ref.txt").read_text()
    assert (tmp_path / "comb_port.txt").read_text() == text
    assert text.startswith("## Random Forests\n## No. of bags = 18\n")
    combined = port_load(str(tmp_path / "comb_port.txt"))
    assert (combined.model_str()
            == ref_load(str(tmp_path / "comb_port.txt")).model_str())
    merged = combined._merged_ensemble()
    assert merged._bins_grid_meta()[1] > 256
    assert merged.serving_route(2, "cuda")[0] == "f32"
    test = tmp_path / "t.txt"
    write_letor_text(synth_dataset(n_queries=8, n_features=2, seed=49,
                                   w_seed=41, signal=3.0), test)
    lines = {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        assert main(["-load", str(tmp_path / "comb_port.txt"), "-test",
                     str(test), "-metric2T", "NDCG@10"]) == 0
        lines[name] = capsys.readouterr().out.splitlines()[-1]
    assert lines["port"] == lines["ref"]
    assert port_main(["-combine", str(bags)]) == 1
    assert ("Error: -combine requires -o <output model file>"
            in capsys.readouterr().out)
    assert port_main(["-combine", str(tmp_path / "nope"), "-o",
                      str(tmp_path / "x.txt")]) == 1
    assert "Not a directory" in capsys.readouterr().out
