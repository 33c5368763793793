"""The port's best-split scan (ranklib_tpu_torch.ops.split_scan) against the
reference's ``best_splits_xla`` and, in TPU interpret mode, its Pallas
row scan.

Integer-valued histograms make every prefix sum exact, so picks must be
equal — ties included (the feature-major first max). Float histograms
match gains to rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ranklib_tpu.ops.split_scan import _scan_rows_pallas, best_splits_xla
from ranklib_tpu_torch.ops.split_scan import best_splits, best_splits_plain
from ranklib_tpu_torch.utils.errors import RankLibError


def _hist(Cn, F, B, seed, integer=True, empty_child=False):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 5, (Cn, F, B)).astype(np.float64)
    counts[:] = counts[:, :1, :]          # every feature bins every doc
    if integer:
        sums = rng.integers(-3, 4, (Cn, F, B)) * (counts > 0)
    else:
        sums = rng.normal(size=(Cn, F, B)) * counts.astype(bool)
    if empty_child:
        counts[-1] = 0
        sums[-1] = 0
    return np.stack([sums, counts], axis=-1).astype(np.float32)


def _both(hist, mls, fmask=None):
    want = best_splits_xla(jnp.asarray(hist), mls,
                           None if fmask is None else jnp.asarray(fmask))
    got = best_splits(torch.from_numpy(hist), mls,
                      None if fmask is None else torch.from_numpy(fmask))
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


@pytest.mark.parametrize("Cn,B", [(1, 8), (2, 11), (1, 256), (2, 256),
                                  (2, 512)])
@pytest.mark.parametrize("mls", [0.0, 1.0, 3.0])
@pytest.mark.parametrize("masked", [False, True])
def test_integer_histograms_pick_exactly(Cn, B, mls, masked):
    hist = _hist(Cn, 7, B, seed=B + Cn, empty_child=(Cn == 2))
    fmask = (np.random.default_rng(B).random((Cn, 7)) > 0.4
             if masked else None)
    want, got = _both(hist, mls, fmask)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_float_histograms_match_gains():
    hist = _hist(2, 9, 256, seed=4, integer=False)
    want, got = _both(hist, 1.0)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_array_equal(got[1:], want[1:])


def test_ties_take_the_first_feature_and_bin():
    """Two identical feature rows, and a row of all-zero sums whose every
    valid bin ties: the first feature, then the first bin wins."""
    hist = np.zeros((1, 3, 8, 2), np.float32)
    hist[0, :, :, 1] = [1, 1, 1, 1, 1, 1, 1, 1]
    hist[0, 1, :, 0] = [2, -1, 0, 0, 1, -2, 0, 0]
    hist[0, 2] = hist[0, 1]
    want, got = _both(hist, 1.0)
    assert int(got[1][0]) == 1 == int(want[1][0])
    assert int(got[2][0]) == int(want[2][0])
    zero = np.zeros((1, 1, 8, 2), np.float32)
    zero[0, 0, :, 1] = 1.0
    want, got = _both(zero, 1.0)
    assert int(got[2][0]) == 0 == int(want[2][0]) and bool(got[3][0])


def test_mls_zero_rejects_empty_sides():
    """-mls 0: an empty-side candidate scores the parent term and would
    tie the proper split; the floor keeps it out (the reference's rule)."""
    hist = np.zeros((1, 1, 3, 2), np.float32)
    hist[0, 0, :, 1] = [0.0, 2.0, 2.0]
    hist[0, 0, :, 0] = [0.0, 2.0, 2.0]
    want, got = _both(hist, 0.0)
    assert bool(got[3][0]) and int(got[2][0]) == 1 == int(want[2][0])


def test_nothing_valid_gives_minus_inf_at_zero():
    hist = _hist(2, 4, 8, seed=1)
    want, got = _both(hist, 1e6)
    assert not got[3].any() and np.isneginf(got[0]).all()
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("trial", range(4))
def test_matches_pallas_row_scan(trial):
    """The reference's TPU row scan (interpret mode) picks the same
    (feature, bin) as the port, gains to rtol 1e-5."""
    Cn, F, B = 2, 7, 256
    hist = _hist(Cn, F, B, seed=5 + trial, integer=(trial % 2 == 0),
                 empty_child=(trial == 2))
    mls = [1.0, 3.0, 1.0, 2.0][trial]
    hs = jnp.asarray(hist[..., 0].reshape(Cn * F, B))
    hc = jnp.asarray(hist[..., 1].reshape(Cn * F, B))
    with pltpu.force_tpu_interpret_mode():
        g_row, b_row = _scan_rows_pallas(hs, hc, mls)
    g = np.asarray(g_row).reshape(Cn, F)
    b = np.asarray(b_row).reshape(Cn, F)
    got = [a.numpy() for a in best_splits(torch.from_numpy(hist), mls)]
    for c in range(Cn):
        f = int(np.argmax(g[c]))
        if np.isfinite(g[c, f]):
            np.testing.assert_allclose(got[0][c], g[c, f], rtol=1e-5)
            assert (int(got[1][c]), int(got[2][c])) == (f, int(b[c, f]))
        else:
            assert not got[3][c]


def test_plain_is_the_cpu_route_and_inputs_are_checked():
    hist = torch.from_numpy(_hist(1, 3, 8, seed=2))
    for a, b in zip(best_splits(hist, 1.0), best_splits_plain(hist, 1.0)):
        assert torch.equal(a, b)
    with pytest.raises(RankLibError, match="Cn, F, B, 2"):
        best_splits(hist[0], 1.0)
    with pytest.raises(RankLibError, match="float32"):
        best_splits(hist.double(), 1.0)
