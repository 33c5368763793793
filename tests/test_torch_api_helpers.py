"""The library helpers ``Ranker.rank_dataset``, ``Ranker.score_metric``
(ref models/base.py:93, :100) and ``data.letor.write_letor`` (ref
data/letor.py:270) against the reference's, on the same seeded data:
rankings equal, scores and metrics to 1e-6, files byte-equal.
"""

import numpy as np
import pytest
import torch

from ranklib_tpu.data.letor import read_letor as ref_read
from ranklib_tpu.data.letor import write_letor as ref_write
from ranklib_tpu.metrics.base import create_scorer as ref_scorer
from ranklib_tpu.models.base import load_ranker_file as ref_load
from ranklib_tpu.models.coorascent import CoorAscent as RefCA
from ranklib_tpu.models.gbdt import LambdaMART as RefLM
from ranklib_tpu.utils.logging import set_silent as ref_silent
from ranklib_tpu_torch import data as port_data
from ranklib_tpu_torch.data.letor import read_letor, write_letor
from ranklib_tpu_torch.data.sparse import read_letor_sparse
from ranklib_tpu_torch.metrics.base import create_scorer
from ranklib_tpu_torch.models.base import load_ranker_file
from tests.fixtures import synth_dataset, write_letor_text

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("api_helpers")
    out = {}
    for name, nq, seed in (("train", 16, 31), ("test", 9, 32)):
        out[name] = str(d / f"{name}.txt")
        write_letor_text(synth_dataset(n_queries=nq, n_features=7,
                                       min_docs=4, max_docs=20, gmax=2,
                                       seed=seed, w_seed=31, signal=3.0),
                         out[name])
    ref_silent(True)
    try:
        train = ref_read(out["train"], quiet=True)
        for tag, model in (("lm", RefLM(n_trees=6, n_leaves=4)),
                           ("ca", RefCA(n_restart=1, max_passes=2))):
            model.fit(train, ref_scorer("NDCG@10"))
            out[tag] = str(d / f"{tag}.txt")
            model.save(out[tag])
    finally:
        ref_silent(False)
    return out


@pytest.mark.parametrize("model", ["lm", "ca"])
def test_rank_dataset_matches_reference(files, model):
    """The same per-query permutations (stable, score descending) from the
    same model file; the scores behind them to 1e-6."""
    ref, port = ref_load(files[model]), load_ranker_file(files[model])
    rtest, ptest = ref_read(files["test"], quiet=True), read_letor(
        files["test"])
    for a, b in zip(ref.eval_dataset(rtest), port.eval_dataset(ptest, CPU)):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-6, rtol=0)
    want, got = ref.rank_dataset(rtest), port.rank_dataset(ptest, CPU)
    assert len(got) == len(want) == 9
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)


def test_rank_dataset_is_stable_on_ties(files):
    """Equal scores keep file order, as the reference's merge sort does."""
    port = load_ranker_file(files["ca"])
    port.weights = np.zeros_like(port.weights)       # every score 0
    for q, perm in zip(read_letor(files["test"]).queries,
                       port.rank_dataset(read_letor(files["test"]), CPU)):
        np.testing.assert_array_equal(perm, np.arange(q.n))


@pytest.mark.parametrize("metric", ["NDCG@10", "ERR@5", "MAP", "P@3"])
@pytest.mark.parametrize("model", ["lm", "ca"])
def test_score_metric_matches_reference(files, model, metric):
    ref, port = ref_load(files[model]), load_ranker_file(files[model])
    for name in ("train", "test"):
        want = ref.score_metric(ref_read(files[name], quiet=True),
                                ref_scorer(metric))
        got = port.score_metric(read_letor(files[name]),
                                create_scorer(metric), CPU)
        assert isinstance(got, float)
        assert abs(got - want) < 1e-6


@pytest.mark.parametrize("name", ["train", "test"])
def test_write_letor_byte_equal(files, tmp_path, name):
    """The reference's bytes from the same file, descriptions included;
    the package exports it as the reference's does."""
    ref_out, port_out = tmp_path / "ref.txt", tmp_path / "port.txt"
    ref_write(ref_read(files[name], quiet=True), str(ref_out))
    write_letor(read_letor(files[name]), str(port_out))
    assert port_out.read_bytes() == ref_out.read_bytes()
    assert port_data.write_letor is write_letor
    assert read_letor(str(port_out)).n_docs == read_letor(files[name]).n_docs


def test_write_letor_of_csr_equals_dense(files, tmp_path):
    """A -sparse (CSR) dataset writes the dense dataset's bytes, a query's
    rows materialized at a time."""
    dense, csr = tmp_path / "dense.txt", tmp_path / "csr.txt"
    write_letor(read_letor(files["test"]), str(dense))
    write_letor(read_letor_sparse(files["test"], want_descs=True), str(csr))
    assert csr.read_bytes() == dense.read_bytes()
