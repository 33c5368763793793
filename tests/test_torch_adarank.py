"""The port's AdaRank (``-ranker 3``) against the reference's on the CPU.

* The weak-metric matrix S[q, f] (one batched evaluator pass over the
  identity) to 1e-6.
* Whole fits: the picked feature sequence identical and alphas to rtol
  1e-5, with the ``-noeq``/``-max`` guards, rollback of a round that
  lowers the train metric, the tolerance stop, validation truncation and
  the silent loop.
* Model files load in both packages and score alike, also through
  ``convert.adarank_from_reference``.
"""

import numpy as np
import pytest
import torch

from ranklib_tpu.metrics.base import create_scorer as ref_create_scorer
from ranklib_tpu.models.adarank import AdaRank as RefAdaRank
from ranklib_tpu.models.base import load_ranker_file as ref_load
from ranklib_tpu.ops.batched_eval import (
    LinearMetricEvaluator as RefEvaluator,
)
from ranklib_tpu_torch.convert import adarank_from_reference
from ranklib_tpu_torch.data.dataset import Dataset, Query
from ranklib_tpu_torch.metrics.base import create_scorer
from ranklib_tpu_torch.models import adarank as PAR
from ranklib_tpu_torch.models.base import load_ranker_file as port_load
from ranklib_tpu_torch.utils.logging import set_silent
from tests.fixtures import synth_dataset

CPU = torch.device("cpu")


def _port_ds(ds):
    return Dataset([Query(q.qid, q.labels.copy(), q.feats.copy(),
                          list(q.descs)) for q in ds.queries], ds.n_features)


@pytest.fixture(scope="module")
def data():
    return (synth_dataset(n_queries=30, n_features=8, seed=71, signal=2.0),
            synth_dataset(n_queries=10, n_features=8, seed=72, w_seed=71,
                          signal=2.0))


def test_weak_metric_matrix_matches_the_reference(data):
    train, _ = data
    eye = np.eye(8, dtype=np.float32)
    want = RefEvaluator(train, ref_create_scorer("ERR@10")).per_query_matrix(
        eye)
    _, _, S, _, _ = PAR.AdaRank().prepare_fit(
        _port_ds(train), create_scorer("ERR@10"), None, CPU)
    np.testing.assert_allclose(S.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("metric,hp,val,silent", [
    ("NDCG@10", dict(tolerance=1e-5), True, False),
    ("MAP", dict(no_eq=True, tolerance=1e-5), False, True),
    ("ERR@10", dict(max_sel_count=1, tolerance=1e-5), False, False),
    ("NDCG@5", {}, False, False),
], ids=["ndcg-validation", "map-noeq-silent", "err-max1", "defaults"])
def test_fit_matches_the_reference(data, capsys, metric, hp, val, silent):
    train, vali = data
    ref = RefAdaRank(n_rounds=60, **hp)
    ref.fit(train, ref_create_scorer(metric), vali if val else None)
    ref_out = capsys.readouterr().out
    port = PAR.AdaRank(n_rounds=60, **hp)
    set_silent(silent)
    try:
        port.fit(_port_ds(train), create_scorer(metric),
                 _port_ds(vali) if val else None, device=CPU)
    finally:
        set_silent(False)
    port_out = capsys.readouterr().out
    assert len(port.history) == len(ref.history) > 0
    assert [f for f, _ in port.history] == [f for f, _ in ref.history]
    np.testing.assert_allclose([a for _, a in port.history],
                               [a for _, a in ref.history], rtol=1e-5)
    np.testing.assert_allclose(port.weights, ref.weights, rtol=1e-5)
    if not silent:
        stops = [[ln for ln in out.splitlines() if ln.startswith("Stop")]
                 for out in (ref_out, port_out)]
        assert stops[0] == stops[1]


def test_models_load_across_packages_and_score_alike(data, tmp_path):
    train, vali = data
    ref = RefAdaRank(n_rounds=20, tolerance=1e-5)
    ref.fit(train, ref_create_scorer("NDCG@10"))
    want = np.concatenate(ref.eval_dataset(vali))
    ref.save(str(tmp_path / "ref.txt"))
    for port in (port_load(str(tmp_path / "ref.txt")),
                 adarank_from_reference(ref)):
        assert isinstance(port, PAR.AdaRank)
        got = np.concatenate(port.eval_dataset(_port_ds(vali), CPU))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    port.save(str(tmp_path / "port.txt"))
    assert (open(tmp_path / "port.txt").read()
            == open(tmp_path / "ref.txt").read())
    assert ref_load(str(tmp_path / "port.txt")).history == ref.history
