"""The port's metrics (ranklib_tpu_torch.metrics) against the reference's.

Each case builds one dataset from a numpy seed in both packages' types and
compares ``score_dataset`` per query, to 1e-6: every metric at several
cutoffs, with quantized scores that force ties (the stable, lower-index-
first order of RankLib's MergeSorter), lists shorter than k, all-zero
labels and the round-5 edge cases (P@k with k <= 0, ERR with labels above
-gmax).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ranklib_tpu.data.dataset import Dataset as RefDataset
from ranklib_tpu.data.dataset import Query as RefQuery
from ranklib_tpu.metrics.base import create_scorer as ref_create_scorer
from ranklib_tpu.metrics.base import score_dataset as ref_score_dataset
from ranklib_tpu.ops.sorting import rank_labels as ref_rank_labels
from ranklib_tpu_torch.data.dataset import Dataset, Query
from ranklib_tpu_torch.metrics.base import create_scorer, score_dataset
from ranklib_tpu_torch.ops.sorting import rank_labels, rank_perm
from ranklib_tpu_torch.utils.errors import RankLibError

CPU = torch.device("cpu")
METRICS = ["NDCG", "DCG", "ERR", "MAP", "P", "RR", "BEST"]


def _both(n_queries, seed, max_label=4, min_docs=1, max_docs=30,
          binary=False):
    rng = np.random.default_rng(seed)
    ref_q, port_q, scores = [], [], []
    for qi in range(n_queries):
        n = int(rng.integers(min_docs, max_docs + 1))
        hi = 2 if binary else max_label + 1
        labels = rng.integers(0, hi, size=n).astype(np.float32)
        if qi == 0:
            labels[:] = 0.0                       # all-zero list
        feats = np.zeros((n, 1), np.float32)
        ref_q.append(RefQuery(str(qi), labels, feats))
        port_q.append(Query(str(qi), labels.copy(), feats.copy()))
        # quantized scores: plenty of ties
        scores.append(np.round(rng.random(n).astype(np.float32) * 4) / 4)
    return RefDataset(ref_q, 1), Dataset(port_q, 1), scores


def _compare(metric, gmax=4.0, **kw):
    ref_ds, port_ds, scores = _both(**kw)
    want_mean, want = ref_score_dataset(ref_create_scorer(metric, gmax),
                                        ref_ds, scores)
    got_mean, got = score_dataset(create_scorer(metric, gmax), port_ds,
                                  scores, CPU)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert got_mean == pytest.approx(want_mean, abs=1e-6)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [1, 3, 10])
def test_score_dataset_matches_reference(metric, k):
    name = metric if metric == "MAP" else f"{metric}@{k}"
    _compare(name, n_queries=40, seed=100 + k)


@pytest.mark.parametrize("metric", ["P@0", "NDCG@0", "ERR@0", "BEST@0",
                                    "RR@-1", "DCG@200"])
def test_no_cutoff_and_cutoff_past_every_list(metric):
    """k <= 0 means no cutoff; k larger than every list takes the
    full-sort path."""
    _compare(metric, n_queries=25, seed=7)


def test_err_labels_above_gmax_stay_finite():
    """-gmax 0 with binary labels: R == 1 exactly."""
    ref_ds, port_ds, scores = _both(n_queries=20, seed=3, binary=True)
    _compare("ERR@10", gmax=0.0, n_queries=20, seed=3, binary=True)
    _, got = score_dataset(create_scorer("ERR@10", gmax=0.0), port_ds,
                           scores, CPU)
    assert np.isfinite(got).all()


def test_single_doc_queries_and_default_cutoff():
    for metric in ("NDCG", "ERR", "P", "RR", "BEST", "MAP"):
        _compare(metric, n_queries=12, seed=9, max_docs=1)


def test_rank_order_is_stable_like_the_reference():
    rng = np.random.default_rng(11)
    labels = rng.integers(0, 4, size=(6, 17)).astype(np.float32)
    scores = np.round(rng.random((6, 17)).astype(np.float32) * 3) / 3
    mask = np.arange(17)[None, :] < rng.integers(1, 18, size=6)[:, None]
    labels[~mask] = 0
    want = np.asarray(ref_rank_labels(jnp.asarray(labels),
                                      jnp.asarray(scores), jnp.asarray(mask)))
    got = rank_labels(torch.from_numpy(labels), torch.from_numpy(scores),
                      torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    perm = rank_perm(torch.tensor([[1.0, 2.0, 1.0, 2.0]]),
                     torch.tensor([[True, True, True, False]]))
    assert perm.tolist() == [[1, 0, 2, 3]]     # ties keep file order


def test_create_scorer_strings_and_errors():
    assert create_scorer("NDCG@10").name == "NDCG@10"
    assert create_scorer("map").name == "MAP"
    assert create_scorer("err@5").metric == "ERR"
    assert create_scorer("P@3").k == 3
    assert create_scorer("best").name == "BEST@10"
    for bad in ("NDCG@x", "FOO@3"):
        with pytest.raises(RankLibError):
            create_scorer(bad)
