"""The host-binned serving route's switches (ref gbdt/ensemble.py:471 and
:566-573), on the CPU through the kernels' plain versions:

* ``RANKLIB_TPU_SERVE_HOSTBIN=0`` turns the host-binned route off; the
  ``"bins"`` route then bins uploaded f32 chunks on the device
  (``forest_eval_bins``). Its scores are bit-equal to the host-binned
  route's, and within tests/test_torch_ensemble.py's 1e-5 of the
  reference's ``eval_matrix`` under the same variable (its bin-space
  kernel in interpret mode; the port's plain versions sum the trees in
  another order, so the two packages agree to the last bits only);
* ``RANKLIB_TPU_SERVE_CHUNK_MB`` sets the MiB of ids a host-binned chunk:
  the chunk count follows it and the scores do not; a value that is not a
  number, or is not above 0, reads as the default (8 MiB);
* ``RANKLIB_TPU_SERVE_SPLIT=1`` still wins over both.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import __graft_entry__ as g
from ranklib_tpu.gbdt.ensemble import TreeEnsemble as RefEnsemble
from ranklib_tpu_torch.convert import from_reference_arrays
from ranklib_tpu_torch.gbdt import ensemble as PE
from ranklib_tpu_torch.gbdt.ensemble import TreeEnsemble

CPU = torch.device("cpu")
TOL = {"atol": 1e-5, "rtol": 1e-5}      # tests/test_torch_ensemble.py's


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in (PE.SERVE_HOSTBIN_ENV, PE.SERVE_CHUNK_ENV, PE.SERVE_SPLIT_ENV):
        monkeypatch.delenv(k, raising=False)


def _case(n_trees, n_leaves, n_features, n_docs, seed):
    rng = np.random.default_rng(seed)
    ref = g._synthetic_ensemble(n_trees=n_trees, n_leaves=n_leaves,
                                n_features=n_features, rng=rng)
    X = rng.normal(size=(n_docs, n_features)).astype(np.float32)
    X[min(5, n_docs - 1), 2] = np.nan
    return ref, from_reference_arrays(ref.trees, ref.weights), X


@pytest.fixture
def calls(monkeypatch):
    """Calls of each serving kernel wrapper that eval_matrix made."""
    seen = {"frombins": 0, "bins": 0, "bins_split": 0, "full": 0}
    for name in seen:
        fn = getattr(PE, f"forest_eval_{name}")

        def counted(*a, _fn=fn, _name=name, **k):
            seen[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(PE, f"forest_eval_{name}", counted)
    return seen


@pytest.mark.parametrize("shape", [(23, 7, 13, 257, 11), (37, 7, 12, 600, 3),
                                   (50, 10, 20, 300, 7)],
                         ids=["odd", "37x7", "50x10"])
def test_hostbin_off_is_bit_equal(shape, monkeypatch, calls):
    """HOSTBIN=0: the "bins" route on uploaded features, one call, the
    host-binned route's scores bit for bit, and the reference's route
    under the same variable (its bin-space kernel, chunked) within 1e-5."""
    ref, port, X = _case(*shape)
    hostbin = port.eval_matrix(X, CPU)
    assert calls["frombins"] == 1 and calls["bins"] == 0
    monkeypatch.setenv(PE.SERVE_HOSTBIN_ENV, "0")
    got = port.eval_matrix(X, CPU)
    assert calls["bins"] == 1 and calls["frombins"] == 1
    np.testing.assert_array_equal(got, hostbin)
    monkeypatch.setattr(RefEnsemble, "_use_bins_kernel",
                        lambda self, n_features: True)
    monkeypatch.setattr(RefEnsemble, "_EVAL_CHUNK_KERNEL", 256)
    with pltpu.force_tpu_interpret_mode():
        want = ref.eval_matrix(X)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("value", ["1", "2.5"])
def test_chunk_mb_sets_the_chunks_not_the_scores(value, monkeypatch, calls):
    """CHUNK_MB=1 (2.5) at 120,000 documents x 20 features (uint8 ids,
    2.4 MB): three (one) host-binned chunks against the default's one;
    the same scores bit for bit."""
    _, port, _ = _case(30, 6, 20, 8, 5)
    X = np.random.default_rng(9).normal(size=(120_000, 20)).astype(
        np.float32)
    want = port.eval_matrix(X, CPU)
    assert calls["frombins"] == 1
    monkeypatch.setenv(PE.SERVE_CHUNK_ENV, value)
    assert port.serve_chunk_bytes() == int(float(value) * (1 << 20))
    got = port.eval_matrix(X, CPU)
    assert calls["frombins"] == 1 + {"1": 3, "2.5": 1}[value]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("value", ["", "abc", "8MB", "0", "-2", "nan", "inf"])
def test_bad_chunk_mb_reads_as_the_default(value, monkeypatch):
    """Not a number, or not above 0: 8 MiB, as the reference reads it."""
    monkeypatch.setenv(PE.SERVE_CHUNK_ENV, value)
    assert TreeEnsemble().serve_chunk_bytes() == 8 << 20


def test_split_still_wins(monkeypatch, calls):
    """SERVE_SPLIT=1 with HOSTBIN=0 and CHUNK_MB set: the split route runs,
    with the host-binned route's scores."""
    _, port, X = _case(23, 7, 13, 257, 11)
    want = port.eval_matrix(X, CPU)
    for k, v in ((PE.SERVE_SPLIT_ENV, "1"), (PE.SERVE_HOSTBIN_ENV, "0"),
                 (PE.SERVE_CHUNK_ENV, "1")):
        monkeypatch.setenv(k, v)
    got = port.eval_matrix(X, CPU)
    assert calls["bins_split"] == 1 and calls["bins"] == 0
    assert calls["frombins"] == 1
    np.testing.assert_array_equal(got, want)


def test_hostbin_off_leaves_the_f32_route(monkeypatch, calls):
    """A model the bin-space kernels do not take (more than 256 thresholds
    on a feature) serves through the f32 route with either value."""
    ref, _, X = _case(60, 7, 6, 200, 13)
    pool = np.linspace(-2.0, 2.0, 300).astype(np.float32)
    i = 0
    for t in ref.trees:
        for node in np.flatnonzero(~t.is_leaf):
            t.feature[node], t.threshold[node] = 0, pool[i % 300]
            i += 1
    port = from_reference_arrays(ref.trees, ref.weights)
    want = port.eval_matrix(X, CPU)
    monkeypatch.setenv(PE.SERVE_HOSTBIN_ENV, "0")
    np.testing.assert_array_equal(port.eval_matrix(X, CPU), want)
    assert calls["full"] >= 2 and calls["frombins"] == calls["bins"] == 0
