"""The port's COO score layer (``ranklib_tpu_torch/ops/sparse_eval.py``)
against the reference's (``ranklib_tpu/ops/sparse_eval.py``) on the CPU.

* The route switch (``RANKLIB_TPU_DEVICE_DENSE_MB``, its default and bad
  values), ``coo_chunk_size`` and ``NNZ_CHUNK`` are the reference's.
* ``build_sparse_data`` holds the reference's entries (fids, values, doc
  rows; its padding dropped) and metric buckets, from a CSR file, under
  lazy ``-norm zscore`` (every present (doc, feature) pair), and from a
  dense ``Dataset`` (a narrow validation file).
* ``sparse_scores_flat`` agrees with the reference's and with the dense
  product to 1e-6, also when docs span chunks; two calls are bit-equal.
* ``sparse_mean_metric`` against the reference's and the dense
  evaluator's ``mean_metric`` within 1e-5 (NDCG, ERR, MAP: the
  reference's tolerance); ``adarank_weak_matrix`` against the
  reference's to 1e-6.
* The neural rankers' sparse first layer: a query step on
  ``SparseRows`` against the same step on the dense block within 1e-6.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ranklib_tpu.data.sparse import read_letor_sparse as ref_read_sparse
from ranklib_tpu.metrics.base import create_scorer as ref_create_scorer
from ranklib_tpu.ops import sparse_eval as RSE
from ranklib_tpu_torch.data import sparse as PS
from ranklib_tpu_torch.data.dataset import Dataset, Query, flatten
from ranklib_tpu_torch.data.letor import read_letor
from ranklib_tpu_torch.metrics.base import create_scorer
from ranklib_tpu_torch.models import neural as PN
from ranklib_tpu_torch.ops import sparse_eval as PSE
from ranklib_tpu_torch.ops.batched_eval import LinearMetricEvaluator
from tests.fixtures import synth_dataset

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_sparse(ds, path, seed, keep=0.35):
    """LETOR text keeping ~``keep`` of the (doc, fid) pairs, at least one
    a line, with a '#' docid."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for q in ds.queries:
            for i in range(q.n):
                on = rng.random(q.feats.shape[1]) < keep
                on[rng.integers(q.feats.shape[1])] = True
                toks = " ".join(f"{j + 1}:{q.feats[i, j]:.6g}"
                                for j in np.flatnonzero(on))
                f.write(f"{int(q.labels[i])} qid:{q.qid} {toks} "
                        f"# d{q.qid}_{i}\n")


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("sparse_eval") / "s.txt")
    write_sparse(synth_dataset(n_queries=10, n_features=13, min_docs=4,
                               max_docs=18, gmax=2, seed=300), p, seed=1)
    return p


def _entries(chunks):
    """(fids, vals, rows) of the port's chunks, concatenated."""
    f = torch.cat([c[0] for c in chunks]).numpy()
    v = torch.cat([c[1] for c in chunks]).numpy()
    r = torch.cat([torch.repeat_interleave(c[2], c[3])
                   for c in chunks]).numpy()
    return f, v, r


def _ref_entries(chunks, N):
    f = np.concatenate([np.asarray(c[0]) for c in chunks])
    v = np.concatenate([np.asarray(c[1]) for c in chunks])
    r = np.concatenate([np.asarray(c[2]) for c in chunks])
    keep = r < N                       # the reference pads to its chunk
    return f[keep], v[keep], r[keep]


@pytest.mark.parametrize("value,want", [(None, 1024 << 20), ("0", 0),
                                        ("64", 64 << 20), ("-3", 0),
                                        ("x", 1024 << 20)],
                         ids=["default", "zero", "64", "negative", "bad"])
def test_budget_and_routing_match_the_reference(path, monkeypatch, value,
                                                want):
    if value is None:
        monkeypatch.delenv("RANKLIB_TPU_DEVICE_DENSE_MB", raising=False)
    else:
        monkeypatch.setenv("RANKLIB_TPU_DEVICE_DENSE_MB", value)
    assert PSE.device_dense_budget_bytes() == want
    assert RSE.device_dense_budget_bytes() == want
    csr = PS.read_letor_sparse(path, quiet=True)
    assert PSE.wants_sparse_eval(csr) == RSE.wants_sparse_eval(
        ref_read_sparse(path, quiet=True)) == (want == 0)
    assert not PSE.wants_sparse_eval(read_letor(path, missing_zero=True))
    assert PSE.NNZ_CHUNK == RSE.NNZ_CHUNK
    for n in (0, 1, 4096, 4097, 100_000, 1 << 17, 10 ** 7):
        assert PSE.coo_chunk_size(n) == RSE.coo_chunk_size(n)


@pytest.mark.parametrize("norm", [None, "zscore", "sum"])
def test_build_sparse_data_matches_the_reference(path, norm):
    csr = PS.read_letor_sparse(path, quiet=True)
    ref = ref_read_sparse(path, quiet=True)
    if norm:
        csr = PS.normalize_csr(csr, norm)
        from ranklib_tpu.data.sparse import normalize_csr
        ref = normalize_csr(ref, norm)
    chunks, buckets, N = PSE.build_sparse_data(csr, CPU)
    rchunks, rbuckets, rN = RSE.build_sparse_data(ref)
    assert N == rN == csr.n_docs
    for got, want in zip(_entries(chunks), _ref_entries(rchunks, N)):
        np.testing.assert_array_equal(got, want)
    if norm == "zscore":                 # every present (doc, fid) pair
        assert len(_entries(chunks)[0]) > csr.nnz
    assert len(buckets) == len(rbuckets)
    for got, want in zip(buckets, rbuckets):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_a_dense_dataset_gives_the_same_coo(path):
    """A narrow dense validation file next to a wide CSR one: the entries
    are sliced from its query blocks, never a copy of [N, F]."""
    csr = PS.read_letor_sparse(path, quiet=True)
    dense = read_letor(path, missing_zero=True)
    a, _, _ = PSE.build_sparse_data(csr, CPU)
    b, _, _ = PSE.build_sparse_data(dense, CPU)
    for x, y in zip(_entries(a), _entries(b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("chunk", [None, 7], ids=["one-chunk", "spanning"])
def test_scores_match_the_reference_and_the_dense_product(path, monkeypatch,
                                                          chunk):
    if chunk:
        # docs whose runs of entries span chunk boundaries
        monkeypatch.setattr(PSE, "coo_chunk_size", lambda n: chunk)
    csr = PS.read_letor_sparse(path, quiet=True)
    chunks, _, N = PSE.build_sparse_data(csr, CPU)
    assert (len(chunks) > 1) == bool(chunk)
    W = np.random.default_rng(3).normal(
        size=(csr.n_features, 5)).astype(np.float32)
    got = PSE.sparse_scores_flat(torch.from_numpy(W), chunks, N)
    again = PSE.sparse_scores_flat(torch.from_numpy(W), chunks, N)
    assert torch.equal(got, again)
    assert not got[N].any()                       # the pads' row
    rchunks, _, _ = RSE.build_sparse_data(ref_read_sparse(path, quiet=True))
    import jax.numpy as jnp
    want = np.asarray(RSE.sparse_scores_flat(jnp.asarray(W), rchunks, N))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    X = csr.materialize_rows(0, N).astype(np.float64)
    np.testing.assert_allclose(got.numpy()[:N], X @ W, rtol=0, atol=1e-5)


@pytest.mark.parametrize("metric", ["NDCG@10", "ERR@10", "MAP"])
def test_mean_metric_matches_the_reference_and_dense(path, metric):
    """The reference's own layer test (tests/test_sparse_csr.py:860-886):
    random candidate matrices, 1e-5 against the dense evaluator."""
    csr = PS.read_letor_sparse(path, quiet=True)
    W = np.random.default_rng(4).normal(
        size=(csr.n_features, 7)).astype(np.float32)
    chunks, buckets, N = PSE.build_sparse_data(csr, CPU)
    got = PSE.sparse_mean_metric(create_scorer(metric), torch.from_numpy(W),
                                 chunks, buckets, N, len(csr.queries))
    rchunks, rbuckets, _ = RSE.build_sparse_data(
        ref_read_sparse(path, quiet=True))
    import jax.numpy as jnp
    want = np.asarray(RSE.sparse_mean_metric(
        ref_create_scorer(metric), jnp.asarray(W), rchunks, rbuckets, N,
        len(csr.queries)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    dense = LinearMetricEvaluator(csr, create_scorer(metric),
                                  CPU).mean_metric(W)
    np.testing.assert_allclose(got.numpy(), dense, atol=1e-5)


@pytest.mark.parametrize("metric", ["NDCG@10", "ERR@10", "MAP"])
def test_adarank_weak_matrix_matches_the_reference(path, metric):
    csr = PS.read_letor_sparse(path, quiet=True)
    got = PSE.adarank_weak_matrix(csr, create_scorer(metric), CPU)
    want = RSE.adarank_weak_matrix(ref_read_sparse(path, quiet=True),
                                   ref_create_scorer(metric))
    assert got.shape == want.shape == (len(csr.queries), csr.n_features)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # and the dense evaluator's S = per-query metrics of the identity
    dense = LinearMetricEvaluator(csr, create_scorer(metric),
                                  CPU).per_query_matrix(
        np.eye(csr.n_features, dtype=np.float32))
    np.testing.assert_allclose(got, dense, rtol=0, atol=1e-6)


def test_segment_rows_adds_each_run_in_order():
    part = torch.from_numpy(np.random.default_rng(5).normal(
        size=(9, 3)).astype(np.float32))
    run = torch.tensor([2, 0, 4, 3])
    rid = torch.tensor([1, 3, 4, 6])
    out = PSE.segment_rows(part, rid, run, torch.ones((8, 3)))
    want = np.ones((8, 3), np.float32)
    p = part.numpy()
    for r, lo, hi in ((1, 0, 2), (4, 2, 6), (6, 6, 9)):
        acc = np.zeros(3, np.float32)
        for i in range(lo, hi):
            acc = acc + p[i]
        want[r] += acc
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("loss", ["ranknet", "lambdarank", "listnet"])
def test_sparse_first_layer_step_matches_the_dense_step(path, loss):
    """One query step through ``SparseRows`` (gather, runs summed per doc;
    dW1 summed per fid into the touched rows) against the same step on
    the dense block: parameters within 1e-6."""
    csr = PS.read_letor_sparse(path, quiet=True)
    F = csr.n_features
    sizes = [F, 1] if loss == "listnet" else [F, 10, 1]
    init = PN._init_params(torch.Generator().manual_seed(2), sizes)
    qi = 3
    X = csr.materialize_query(qi)
    labels = torch.from_numpy(csr.queries[qi].labels)
    n = len(labels)
    mask = torch.ones((1, n), dtype=torch.bool)
    aux = (torch.softmax(labels, 0) if loss == "listnet" else
           (mask, torch.tensor([n], dtype=torch.int32))
           if loss == "lambdarank" else None)
    scorer = create_scorer("NDCG@10")
    out = []
    for x in (torch.from_numpy(X), PN.sparse_rows(X, CPU)):
        params = [[a.clone() for a in p] for p in init]
        PN.query_step(params, (x, labels, aux), loss, scorer, 0.5)
        out.append(params)
    rows = PN.sparse_rows(X, CPU)
    assert rows.ufid.tolist() == sorted(set(np.nonzero(X)[1].tolist()))
    changed = (out[1][0][0] != init[0][0]).any(dim=1)
    assert set(np.flatnonzero(changed.numpy())) <= set(rows.ufid.tolist())
    for pd, ps in zip(out[0], out[1]):
        for a, b in zip(pd, ps):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                       atol=1e-6)


def test_flatten_refuses_csr_and_query_feats_serves_it(path):
    from ranklib_tpu_torch.data.dataset import query_feats
    from ranklib_tpu_torch.utils.errors import RankLibError

    csr = PS.read_letor_sparse(path, quiet=True)
    dense = read_letor(path, missing_zero=True)
    with pytest.raises(RankLibError, match="chunked paths"):
        flatten(csr)
    for qi in range(len(csr.queries)):
        np.testing.assert_array_equal(query_feats(csr, qi),
                                      query_feats(dense, qi))
    bins_only = Dataset([Query("1", np.zeros(2, np.float32), None)], 3)
    with pytest.raises(RankLibError, match="no raw feature values"):
        query_feats(bins_only, 0)


def test_port_runs_raw_value_sparse_without_jax(path, tmp_path):
    """The raw-value rankers' -sparse flows (both routes) in a process
    where JAX cannot be imported: the port never loads jax or
    ranklib_tpu."""
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'ranklib_tpu'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {REPO!r})
import os
from ranklib_tpu_torch.cli import main
for env in ('1024', '0'):
    os.environ['RANKLIB_TPU_DEVICE_DENSE_MB'] = env
    for r in ('4', '3', '1', '2', '9'):
        m = {str(tmp_path)!r} + '/m' + r + env + '.txt'
        assert main(['-train', {path!r}, '-ranker', r, '-sparse',
                     '-missingZero', '-silent', '-r', '1', '-i', '3',
                     '-round', '3', '-epoch', '1', '-save', m]) == 0
        assert main(['-load', m, '-test', {path!r}, '-sparse',
                     '-missingZero', '-silent']) == 0
print('ok', [k for k in sys.modules if k.split('.')[0] in
             ('jax', 'ranklib_tpu')])
"""
    env = dict(os.environ, RANKLIB_TPU_TORCH_DEVICE="cpu")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "ok []"
