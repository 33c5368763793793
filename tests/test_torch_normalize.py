"""The port's per-query normalizers (ranklib_tpu_torch.data.normalize)
against the reference's: the same numpy arithmetic, so bit-equal, on
queries with constant, zero-sum and single-document columns; and the
``-norm`` flows of both CLIs on the same files (test_torch_cli.py holds
the training parity)."""

import numpy as np
import pytest

from ranklib_tpu.cli import main as ref_main
from ranklib_tpu.data.normalize import normalize_dataset as ref_normalize
from ranklib_tpu_torch.cli import main as port_main
from ranklib_tpu_torch.data.dataset import Dataset, Query
from ranklib_tpu_torch.data.normalize import get_normalizer, normalize_dataset
from ranklib_tpu_torch.utils.errors import RankLibError
from tests.fixtures import synth_dataset, write_letor_text


def _queries(seed=7):
    """Queries of 1-12 docs x 6 features: column 0 constant, column 1 zero
    in some queries, column 2 of mixed sign, the rest N(0, 3)."""
    rng = np.random.default_rng(seed)
    out = []
    for qi in range(9):
        n = int(rng.integers(1, 13))
        X = (3 * rng.normal(size=(n, 6))).astype(np.float32)
        X[:, 0] = 2.5
        if qi % 3 == 0:
            X[:, 1] = 0.0
        X[:, 2] = rng.choice([-1.0, 1.0], size=n) * rng.random(n)
        out.append(X)
    return out


@pytest.mark.parametrize("name", ["sum", "zscore", "linear", "ZScore"])
def test_normalizers_are_bit_equal_to_the_reference(name):
    import ranklib_tpu.data.dataset as RD

    feats = _queries()
    ref = RD.Dataset([RD.Query(str(i), np.zeros(len(X), np.float32),
                               X.copy()) for i, X in enumerate(feats)], 6)
    port = Dataset([Query(str(i), np.zeros(len(X), np.float32), X.copy())
                    for i, X in enumerate(feats)], 6)
    ref_normalize(ref, name)
    normalize_dataset(port, name)
    for a, b in zip(ref.queries, port.queries, strict=True):
        assert b.feats.dtype == np.float32
        np.testing.assert_array_equal(b.feats, a.feats)


def test_unknown_normalizer_raises():
    with pytest.raises(RankLibError, match="sum\\|zscore\\|linear"):
        get_normalizer("minmax")


@pytest.mark.parametrize("norm", ["sum", "linear"])
def test_load_flows_normalize_like_the_reference(tmp_path, monkeypatch,
                                                 norm):
    """-load -test -idv and -load -rank -score under -norm: the same
    per-query metrics and scores as the reference's."""
    monkeypatch.setenv("RANKLIB_TPU_TORCH_DEVICE", "cpu")
    train, test = str(tmp_path / "train.txt"), str(tmp_path / "test.txt")
    write_letor_text(synth_dataset(n_queries=10, n_features=5, seed=31,
                                   signal=3.0), train)
    write_letor_text(synth_dataset(n_queries=6, n_features=5, seed=32,
                                   w_seed=31, signal=3.0), test)
    model = str(tmp_path / "lin.txt")
    assert ref_main(["-train", train, "-ranker", "9", "-norm", norm,
                     "-silent", "-save", model]) == 0
    out = {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        idv, sc = str(tmp_path / f"{name}.idv"), str(tmp_path / f"{name}.sc")
        assert main(["-load", model, "-test", test, "-norm", norm,
                     "-metric2T", "NDCG@5", "-idv", idv]) == 0
        assert main(["-load", model, "-rank", test, "-norm", norm,
                     "-score", sc]) == 0
        out[name] = (open(idv).read(), np.loadtxt(sc, usecols=2))
    assert out["port"][0] == out["ref"][0]
    np.testing.assert_allclose(out["port"][1], out["ref"][1], atol=2e-6)
