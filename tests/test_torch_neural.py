"""The port's neural rankers (RankNet ``-ranker 1``, LambdaRank ``5``,
ListNet ``7``) against the reference's on the CPU.

The two packages draw their initial weights from different generators
(``jax.random`` there, a seeded ``torch.Generator`` here), so every
comparison injects the reference's draws into the port by replacing its
``_init_params``. From the same start:

* parameters after 3 epochs (ListNet 5) agree to atol 5e-5 with the
  reference's and with ``tools/oracle.py``'s f64 ``OracleNeuralRanker``
  (the reference's own oracle tolerance), the best-on-validation snapshot
  to 5e-4, and the console table line for line;
* ``eval_dataset`` agrees to 1e-6, also when the data is narrower or
  wider than the model;
* model files are byte-identical both ways for the same parameters;
* the CLI's ``-ranker 1|5|7`` flows print the reference's metric lines.
"""

import jax
import numpy as np
import pytest
import torch

from ranklib_tpu.cli import main as ref_main
from ranklib_tpu.data.dataset import bucketize as ref_bucketize
from ranklib_tpu.metrics.base import create_scorer as ref_create_scorer
from ranklib_tpu.models import neural as RN
from ranklib_tpu.models.base import load_ranker_file as ref_load
from ranklib_tpu_torch.cli import build_parser, collect_hparams
from ranklib_tpu_torch.cli import main as port_main
from ranklib_tpu_torch.convert import neural_from_reference
from ranklib_tpu_torch.data.dataset import Dataset, Query
from ranklib_tpu_torch.metrics.base import create_scorer
from ranklib_tpu_torch.models import neural as PN
from ranklib_tpu_torch.models.base import load_ranker_file as port_load
from ranklib_tpu_torch.utils.errors import RankLibError
from tests.fixtures import synth_dataset, write_letor_text
from tools import oracle as orc

CPU = torch.device("cpu")
PORT_INIT = PN._init_params                  # before the fixture replaces it
CLASSES = {"ranknet": (RN.RankNet, PN.RankNet),
           "lambdarank": (RN.LambdaRank, PN.LambdaRank),
           "listnet": (RN.ListNet, PN.ListNet)}


@pytest.fixture(autouse=True)
def _reference_init(monkeypatch):
    """The port starts from the reference's draws for its seed."""
    monkeypatch.setenv("RANKLIB_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(PN, "_init_params", lambda gen, sizes: [
        (np.asarray(W), np.asarray(b)) for W, b in RN._init_params(
            jax.random.PRNGKey(gen.initial_seed()), sizes)])


def _port_ds(ds):
    return Dataset([Query(q.qid, q.labels.copy(), q.feats.copy(),
                          list(q.descs)) for q in ds.queries], ds.n_features)


def _fit_both(loss, ds, metric, epochs, lr, val=None, capsys=None, **hp):
    ref_cls, port_cls = CLASSES[loss]
    ref = ref_cls(n_epoch=epochs, learning_rate=lr, **hp)
    ref.fit(ds, ref_create_scorer(metric), validation=val)
    ref_out = capsys.readouterr().out if capsys else None
    port = port_cls(n_epoch=epochs, learning_rate=lr, **hp)
    port.fit(_port_ds(ds), create_scorer(metric),
             validation=_port_ds(val) if val is not None else None,
             device=CPU)
    port_out = capsys.readouterr().out if capsys else None
    return ref, port, ref_out, port_out


def _assert_params_close(got, want, atol):
    assert len(got) == len(want)
    for (Wg, bg), (Ww, bw) in zip(got, want):
        assert Wg.dtype == np.float32 and Wg.shape == np.shape(Ww)
        np.testing.assert_allclose(Wg, np.asarray(Ww, np.float64), atol=atol)
        np.testing.assert_allclose(bg, np.asarray(bw, np.float64), atol=atol)


# the reference's oracle cases (tests/test_oracle_parity_all.py)
CASES = [("ranknet", 101, 3, 0.001), ("lambdarank", 111, 3, 0.001),
         ("listnet", 121, 5, 0.01)]


@pytest.mark.parametrize("loss,seed,epochs,lr", CASES,
                         ids=[c[0] for c in CASES])
def test_params_match_reference_and_oracle(loss, seed, epochs, lr):
    ds = synth_dataset(n_queries=8, n_features=6, min_docs=4, max_docs=12,
                       gmax=2, seed=seed)
    ref, port, _, _ = _fit_both(loss, ds, "NDCG@10", epochs, lr)
    _assert_params_close(port.params, ref.params, atol=5e-5)
    sizes = port._layer_sizes(ds.n_features)
    assert sizes == ([6, 1] if loss == "listnet" else [6, 10, 1])
    p0 = [(np.asarray(W, np.float64), np.asarray(b, np.float64))
          for W, b in RN._init_params(jax.random.PRNGKey(0), sizes)]
    o = orc.OracleNeuralRanker(params=p0, loss=loss, lr=lr, n_epoch=epochs,
                               metric="NDCG", k=10)
    qs = orc.dataset_to_oracle(ds)
    o.fit([qs[int(i)] for b in ref_bucketize(ds) for i in b.qidx])
    _assert_params_close(port.params, o.params, atol=5e-5)


@pytest.mark.parametrize("metric", ["ERR@5", "MAP", "P@3", "DCG@4"])
def test_lambdarank_swap_weights_match_reference(metric):
    """LambdaRank's |Δmetric| weights come from the port's swap deltas on
    each query's real documents; the reference pads them. Same updates."""
    ds = synth_dataset(n_queries=8, n_features=5, min_docs=3, max_docs=20,
                       gmax=3, seed=141)
    ref, port, _, _ = _fit_both("lambdarank", ds, metric, 3, 0.01)
    _assert_params_close(port.params, ref.params, atol=5e-5)


def test_validation_snapshot_and_console_match_reference(capsys):
    """Best-on-validation snapshot (strict >, from -inf): the same epoch
    is kept, and the console table prints the same lines."""
    ds = synth_dataset(n_queries=8, n_features=5, min_docs=4, max_docs=10,
                       gmax=2, seed=131)
    val = synth_dataset(n_queries=4, n_features=5, min_docs=4, max_docs=10,
                        gmax=2, seed=132, w_seed=131)
    ref, port, ref_out, port_out = _fit_both(
        "ranknet", ds, "NDCG@10", 5, 0.05, val=val, capsys=capsys)
    _assert_params_close(port.params, ref.params, atol=5e-4)
    assert port_out.splitlines() == ref_out.splitlines()
    assert "#epoch  | # mis-ordered pairs | validation" in port_out


def test_degenerate_queries_match_reference():
    """One-document queries and queries of equal labels have no pair; the
    reference steps them with zero gradients, the port the same."""
    ds = synth_dataset(n_queries=6, n_features=4, min_docs=1, max_docs=6,
                       gmax=2, seed=151)
    ds.queries[0].labels[:] = 1.0
    ds.queries[1] = Query(ds.queries[1].qid, ds.queries[1].labels[:1],
                          ds.queries[1].feats[:1], [""])
    for loss in CLASSES:
        ref, port, _, _ = _fit_both(loss, ds, "NDCG@10", 2, 0.05)
        _assert_params_close(port.params, ref.params, atol=5e-5)
        assert all(np.isfinite(W).all() for W, _ in port.params)


def test_visit_order_is_the_reference_scan_order():
    ds = synth_dataset(n_queries=12, n_features=3, min_docs=2, max_docs=40,
                       seed=161)
    data = PN.train_rows(_port_ds(ds), "ranknet", CPU)
    order = [int(i) for b in ref_bucketize(ds) for i in b.qidx]
    assert len(data.rows) == len(order)
    for (x, labels, _), qi in zip(data.rows, order):
        np.testing.assert_array_equal(x.numpy(), ds.queries[qi].feats)
        np.testing.assert_array_equal(labels.numpy(), ds.queries[qi].labels)


@pytest.mark.parametrize("width", [6, 4, 9], ids=["same", "narrower",
                                                    "wider"])
def test_eval_dataset_matches_reference(width):
    ds = synth_dataset(n_queries=6, n_features=6, min_docs=4, max_docs=12,
                       gmax=2, seed=171)
    ref = RN.RankNet(n_epoch=2, learning_rate=0.01)
    ref.fit(ds, ref_create_scorer("NDCG@10"))
    test = synth_dataset(n_queries=5, n_features=width, min_docs=1,
                         max_docs=30, seed=172)
    want = ref.eval_dataset(test)
    got = neural_from_reference(ref).eval_dataset(_port_ds(test), CPU)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.float64 and g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-6)


@pytest.mark.parametrize("loss", list(CLASSES))
def test_model_files_byte_identical_both_ways(loss, tmp_path):
    ds = synth_dataset(n_queries=5, n_features=4, seed=181)
    ref_cls, port_cls = CLASSES[loss]
    ref = ref_cls(n_epoch=2, learning_rate=0.01)
    ref.fit(ds, ref_create_scorer("NDCG@10"))
    ref.save(str(tmp_path / "ref.txt"))
    text = open(tmp_path / "ref.txt").read()
    port = neural_from_reference(ref)
    assert type(port) is port_cls and port.model_str() == text
    loaded = port_load(str(tmp_path / "ref.txt"))
    assert type(loaded) is port_cls
    loaded.save(str(tmp_path / "port.txt"))
    assert open(tmp_path / "port.txt").read() == text
    back = ref_load(str(tmp_path / "port.txt"))
    _assert_params_close(back.params, loaded.params, atol=0)
    assert back.model_str() == text


def test_init_params_and_seed_routing():
    a = PORT_INIT(torch.Generator().manual_seed(7), [5, 3, 1])
    b = PORT_INIT(torch.Generator().manual_seed(7), [5, 3, 1])
    c = PORT_INIT(torch.Generator().manual_seed(8), [5, 3, 1])
    assert [tuple(W.shape) for W, _ in a] == [(5, 3), (3, 1)]
    assert [tuple(v.shape) for _, v in a] == [(3,), (1,)]
    for (Wa, ba), (Wb, bb) in zip(a, b):
        assert torch.equal(Wa, Wb) and torch.equal(ba, bb)
        assert Wa.dtype == torch.float32 and Wa.abs().max() <= 0.05
    assert not torch.equal(a[0][0], c[0][0])
    args = build_parser().parse_args(
        ["-train", "t", "-ranker", "5", "-epoch", "3", "-layer", "2",
         "-node", "4", "-lr", "0.1", "-randomSeed", "9", "-tree", "5"])
    assert collect_hparams(args) == {"n_epoch": 3, "n_layers": 2,
                                     "n_hidden_per_layer": 4,
                                     "learning_rate": 0.1, "seed": 9}
    args = build_parser().parse_args(
        ["-train", "t", "-ranker", "7", "-epoch", "3", "-layer", "2",
         "-randomSeed", "9"])
    assert collect_hparams(args) == {"n_epoch": 3, "seed": 9}
    assert PN.ListNet(n_epoch=4).n_layers == 0
    assert PN.ListNet().n_epoch == 1500
    assert PN.LambdaRank().learning_rate == 0.00005


def test_unfitted_and_bad_models_raise(tmp_path):
    with pytest.raises(RankLibError, match="not trained"):
        PN.RankNet().eval_dataset(Dataset([], 3), CPU)
    (tmp_path / "bad.txt").write_text("## RankNet\n## Epochs = 3\n")
    with pytest.raises(RankLibError, match="Layer sizes"):
        port_load(str(tmp_path / "bad.txt"))


@pytest.mark.parametrize("ranker", ["1", "5", "7"])
def test_cli_train_flows_match_reference(ranker, tmp_path, capsys):
    """-train -ranker 1|5|7 -validate -test -save: the reference's metric
    lines; each package's model scores alike in the other."""
    paths = {}
    for name, nq, seed in (("train", 10, 191), ("vali", 4, 192),
                           ("test", 5, 193)):
        paths[name] = str(tmp_path / f"{name}.txt")
        write_letor_text(synth_dataset(n_queries=nq, n_features=5, seed=seed,
                                       w_seed=191, signal=3.0), paths[name])
    out, models = {}, {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        models[name] = str(tmp_path / f"{name}.txt")
        assert main(["-train", paths["train"], "-ranker", ranker,
                     "-epoch", "3", "-lr", "0.01", "-randomSeed", "3",
                     "-metric2t", "NDCG@10", "-validate", paths["vali"],
                     "-test", paths["test"], "-save", models[name]]) == 0
        out[name] = [ln for ln in capsys.readouterr().out.splitlines()
                     if " on " in ln and "data:" in ln]
    assert out["port"] == out["ref"] and len(out["ref"]) == 3
    assert (open(models["port"]).read().split("\n")[:7]
            == open(models["ref"]).read().split("\n")[:7])      # header
    for model in models.values():
        lines = []
        for main in (ref_main, port_main):
            assert main(["-load", model, "-test", paths["test"],
                         "-metric2T", "NDCG@10"]) == 0
            lines.append(capsys.readouterr().out.splitlines()[-1])
        assert lines[0] == lines[1] == out["ref"][-1]
