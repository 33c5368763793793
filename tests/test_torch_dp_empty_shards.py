"""``-dp`` with a rank that holds no query, for the tree rankers (MART,
LambdaMART, Random Forests), on the CPU: gloo ranks against the
reference's ``make_mesh(n)`` fits, whose empty devices hold padding only
(``ranklib_tpu/gbdt/boost_dist.py:53-67``).

* An empty rank builds a BoostData of 256 inert pad docs and no bucket,
  and takes part in every sum of the round with zeros.
* The fits are held to the reference's: the same trees (feature,
  threshold, children), leaf outputs to rtol 1e-5, the same printed
  training line; every rank ends with the same model.
* The fixtures carry a planted signal, so no split is a near tie.

A mismatched collective would wait for its peers: the group timeout is cut
to a minute here, so such a fault fails fast instead of hanging.
"""

import numpy as np
import pytest
import torch

from ranklib_tpu_torch.cli import main as port_main
from ranklib_tpu_torch.data.dataset import Dataset, Query, flatten_meta
from ranklib_tpu_torch.gbdt.boost import make_boost_data
from ranklib_tpu_torch.gbdt.boost_dist import (
    _shard_queries, build_sharded_data, scatter_doc_values,
)
from ranklib_tpu_torch.metrics.base import create_scorer
from ranklib_tpu_torch.models import gbdt as PG
from ranklib_tpu_torch.models.rf import parse_ensembles
from ranklib_tpu_torch.ops.histogram import histogram
from ranklib_tpu_torch.parallel import dist
from ranklib_tpu_torch.utils.logging import set_silent

CPU = torch.device("cpu")
TREE_FIELDS = ("feature", "threshold", "left", "right", "is_leaf")


@pytest.fixture(autouse=True)
def _port_defaults(monkeypatch):
    monkeypatch.setenv("RANKLIB_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(dist, "TIMEOUT_S", 60)
    set_silent(False)
    yield
    set_silent(False)


@pytest.fixture
def rank_models(monkeypatch):
    """Every rank's ensembles of each fit, as the fit checks them."""
    import ranklib_tpu_torch.models.rf as PRF

    seen = []
    check = PG.check_same_models

    def keep(ensembles):
        seen.append([e.to_text() for e in ensembles])
        check(ensembles)

    monkeypatch.setattr(PG, "check_same_models", keep)
    monkeypatch.setattr(PRF, "check_same_models", keep)
    return seen


def _ref_dataset(n_queries: int, seed: int = 9):
    """The planted-signal fixture (the reference's Dataset)."""
    from tests.fixtures import synth_dataset

    return synth_dataset(n_queries=n_queries, n_features=6, min_docs=8,
                         max_docs=24, seed=seed, w_seed=4, signal=3.0)


def _dataset(n_queries: int, seed: int = 9) -> Dataset:
    """The same queries as the port's Dataset."""
    ds = _ref_dataset(n_queries, seed)
    return Dataset([Query(q.qid, q.labels.copy(), q.feats.copy())
                    for q in ds.queries], ds.n_features)


def _file(tmp_path, n_queries: int, name: str = "train.txt") -> str:
    from tests.fixtures import write_letor_text

    path = str(tmp_path / name)
    write_letor_text(_ref_dataset(n_queries), path)
    return path


def _same_tree(a, b):
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)
    np.testing.assert_allclose(b.output, a.output, rtol=1e-5, atol=1e-6)


def _same_forest(got, want):
    """Two lists of ensembles (one a bag; MART/LambdaMART: one) with the
    same trees."""
    assert len(got) == len(want) > 0
    for a, b in zip(want, got):
        assert len(a.trees) == len(b.trees) > 0
        for ta, tb in zip(a.trees, b.trees):
            _same_tree(ta, tb)


def _every_rank_equal(rank_models, n_fits: int, n: int):
    assert len(rank_models) == n_fits
    assert all(len(r) == n and len(set(r)) == 1 for r in rank_models)


def _as_read(ensembles):
    """Ensembles of either package as the port reads them back from their
    model text (the same node numbering on both sides)."""
    return [parse_ensembles(e.to_text())[0] for e in ensembles]


# ---- an empty shard, rank by rank ------------------------------------------

def test_three_queries_leave_a_rank_empty():
    """The fixture's deal at -dp 4 (the reference's ``_shard_queries``)
    leaves at least one rank without a query: the case under test."""
    from ranklib_tpu.gbdt.boost_dist import _shard_queries as ref_shard

    per_dev = _shard_queries(_dataset(3), 4)
    assert per_dev == [[qi for _, qi in lst]
                       for lst in ref_shard(_ref_dataset(3), 4)[0]]
    assert [] in per_dev and sorted(sum(per_dev, [])) == [0, 1, 2]


@pytest.mark.parametrize("scorer", ["NDCG@10", "ERR@10"])
def test_empty_shard_is_padding_only(scorer):
    """An empty rank's BoostData: 256 pad docs of weight 0 and label 0, no
    train or validation bucket, every doc resolving to the zero tail
    slot; its B1 histogram (the plain version here) is all zeros and the
    round's lambdas are zeros (the swap scales of a separable metric: no
    chunk)."""
    from ranklib_tpu_torch.ops.lambda_kernel import chunk_lambdas
    from ranklib_tpu_torch.gbdt.lambdas import lambda_fn

    train, val = _dataset(3), _dataset(1, seed=10)
    rng = np.random.default_rng(0)
    binned = rng.integers(0, 256, size=(train.n_docs, 6)).astype(np.int32)
    vbinned = rng.integers(0, 256, size=(val.n_docs, 6)).astype(np.int32)
    empty = _shard_queries(train, 4).index([])
    sc = create_scorer(scorer)
    data, Npad, Nvpad = build_sharded_data(
        train, binned, 4, empty, CPU, validation=val, vbinned=vbinned,
        scorer=sc)
    assert (Npad, Nvpad) == (256, 0)
    assert data.tb == [] and data.vb == [] and data.tb_scale == []
    assert tuple(data.binned_T.shape) == (6, 256)
    assert tuple(data.vbinned.shape) == (0, 6)
    assert not data.doc_mask.any() and not data.labels_flat.any()
    assert torch.equal(data.tb_inv, torch.zeros(256, dtype=torch.int64))
    grad = torch.from_numpy(rng.normal(size=256).astype(np.float32))
    hist = histogram(data.binned_T, grad, data.doc_mask.to(torch.float32),
                     256)
    assert tuple(hist.shape) == (6, 256, 2) and not hist.any()
    scores = torch.from_numpy(rng.normal(size=257).astype(np.float32))
    lam, w = chunk_lambdas(lambda_fn(sc), data.tb, [], scores, data.tb_inv)
    assert not lam.any() and not w.any()


def test_zero_chunks_under_the_fused_route(monkeypatch):
    """``make_boost_data`` of a dataset without a query builds the fused
    round's data too: no query, no factor; its plain round gives zeros."""
    from ranklib_tpu_torch.ops.lambda_kernel import lambda_round

    monkeypatch.setenv("RANKLIB_TPU_FUSED_LAMBDA", "1")
    data, Npad, _ = make_boost_data(
        Dataset([], 6), np.zeros((256, 6), np.int32),
        np.zeros(256, np.float32), 0, None, None, CPU,
        scorer=create_scorer("NDCG@10"))
    assert Npad == 256 and data.fused is not None
    assert data.fused.qptr.tolist() == [0] and data.fused.max_docs == 0
    lam, w = lambda_round(data.fused, torch.ones(257))
    assert tuple(lam.shape) == (256,) and not lam.any() and not w.any()


def test_warm_start_scores_of_an_empty_rank():
    """``scatter_doc_values`` gives an empty rank zeros (its pad slots and
    the pad accumulator) and the others the reference's layout, and the
    ranks hold every document's value once."""
    from ranklib_tpu.gbdt.boost_dist import scatter_doc_values as ref_scatter

    ds = _dataset(3)
    values = np.arange(1, ds.n_docs + 1, dtype=np.float32)
    want = ref_scatter(_ref_dataset(3), values, 4, 256)
    total = 0.0
    for rank, mine in enumerate(_shard_queries(ds, 4)):
        got = scatter_doc_values(ds, values, 4, rank, 256)
        np.testing.assert_array_equal(got, want[rank])
        if not mine:
            assert not got.any()
        total += got.sum()
    assert total == values.sum()


# ---- the fits against the reference's --------------------------------------

@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("ranker", ["0", "6", "8"])
def test_tree_rankers_dp4_on_three_queries(tmp_path, capsys, rank_models,
                                           ranker, kind):
    """-dp 4 on a 3-query file through the CLI (dense, and -sparse's
    streamed bins), against the reference's make_mesh(4) fit: the same
    printed training line and the same trees (Random Forests: bag for
    bag); every rank's model equal."""
    from ranklib_tpu.cli import main as ref_main

    path = _file(tmp_path, 3)
    extra = ["-sparse"] if kind == "sparse" else []
    lines, models = {}, {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        m = str(tmp_path / f"{name}.txt")
        assert main(["-train", path, "-missingZero", "-ranker", ranker,
                     "-tree", "3", "-leaf", "4", "-bag", "2", "-metric2t",
                     "NDCG@10", "-dp", "4", "-save", m, *extra]) == 0
        out = capsys.readouterr().out
        lines[name] = [ln for ln in out.splitlines()
                       if " on training data: " in ln]
        models[name] = parse_ensembles(open(m).read())
    assert lines["port"] == lines["ref"] and len(lines["port"]) == 1
    _same_forest(models["port"], models["ref"])
    _every_rank_equal(rank_models, 2 if ranker == "8" else 1, 4)


def test_all_docs_counted_once_across_the_ranks():
    """The ranks' shards of a 3-query set at -dp 4: every real document on
    exactly one rank, the empty ranks' docs all pads."""
    train = _dataset(3)
    binned = np.zeros((train.n_docs, 6), np.int32)
    real = 0
    for rank in range(4):
        data, Npad, _ = build_sharded_data(train, binned, 4, rank, CPU)
        real += int(data.doc_mask.sum())
        assert Npad == PG._pad_doc_count(int(data.doc_mask.sum()))
    assert real == len(flatten_meta(train)[0])
