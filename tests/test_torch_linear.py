"""The port's Linear Regression (``-ranker 9``) against the reference's
on the CPU: the same f64 host normal equations give the same weights (to
1e-12) and a byte-identical model file; scoring, which the port runs in
f32 on the device, agrees to f32 rounding; each model file loads in the
other package, and ``convert.linear_from_reference`` carries a fitted
reference model across."""

import numpy as np
import pytest
import torch

from ranklib_tpu.metrics.base import create_scorer as ref_create_scorer
from ranklib_tpu.models.base import load_ranker_file as ref_load
from ranklib_tpu.models.linear import LinearRegRank as RefLinear
from ranklib_tpu_torch.convert import linear_from_reference
from ranklib_tpu_torch.data.dataset import Dataset, Query
from ranklib_tpu_torch.metrics.base import create_scorer
from ranklib_tpu_torch.models.base import load_ranker_file as port_load
from ranklib_tpu_torch.models.linear import LinearRegRank
from ranklib_tpu_torch.utils.errors import RankLibError
from tests.fixtures import synth_dataset

CPU = torch.device("cpu")


def _port_ds(ds):
    return Dataset([Query(q.qid, q.labels.copy(), q.feats.copy(),
                          list(q.descs)) for q in ds.queries], ds.n_features)


def _scores(ranker, ds, port=True):
    out = ranker.eval_dataset(_port_ds(ds), CPU) if port \
        else ranker.eval_dataset(ds)
    return np.concatenate(out)


@pytest.fixture(scope="module")
def data():
    return (synth_dataset(n_queries=30, n_features=8, seed=41, signal=2.0),
            synth_dataset(n_queries=8, n_features=10, seed=42, w_seed=41))


@pytest.mark.parametrize("lam", [None, 0.5])
def test_weights_and_model_file_match_the_reference(data, tmp_path, lam,
                                                    capsys):
    train, _ = data
    hp = {} if lam is None else {"lam": lam}
    ref, port = RefLinear(**hp), LinearRegRank(**hp)
    ref.fit(train, ref_create_scorer("NDCG@10"))
    port.fit(_port_ds(train), create_scorer("NDCG@10"), device=CPU)
    np.testing.assert_allclose(port.weights, ref.weights, rtol=0, atol=1e-12)
    assert port.model_str() == ref.model_str()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "on training data" in ln]
    assert len(lines) == 2 and lines[0] == lines[1]


def test_models_load_across_packages_and_score_alike(data, tmp_path):
    train, test = data
    ref = RefLinear()
    ref.fit(train)
    want = _scores(ref, test, port=False)
    ref.save(str(tmp_path / "ref.txt"))
    loaded = port_load(str(tmp_path / "ref.txt"))
    assert isinstance(loaded, LinearRegRank)
    np.testing.assert_allclose(_scores(loaded, test), want, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(_scores(linear_from_reference(ref), test),
                               want, rtol=1e-6, atol=1e-6)
    loaded.save(str(tmp_path / "port.txt"))
    assert (open(tmp_path / "port.txt").read()
            == open(tmp_path / "ref.txt").read())
    back = ref_load(str(tmp_path / "port.txt"))
    np.testing.assert_array_equal(back.weights, ref.weights)


def test_unfitted_and_empty_models_raise(tmp_path):
    with pytest.raises(RankLibError, match="not trained"):
        LinearRegRank().eval_dataset(Dataset([], 3), CPU)
    (tmp_path / "empty.txt").write_text("## Linear Regression\n")
    with pytest.raises(RankLibError, match="Empty Linear Regression"):
        port_load(str(tmp_path / "empty.txt"))
