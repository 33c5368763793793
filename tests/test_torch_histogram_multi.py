"""The port's multi-bag histogram (ranklib_tpu_torch.ops.histogram
``histogram_multi``) against the reference's ``hist_multi_xla`` and, in
TPU interpret mode, its ``hist_multi_pallas`` kernel.

Same numpy-seeded ids, gradients and bag weights through both packages.
Counts (sums of integer multiplicities) must be exactly equal; gradient
sums agree to 1e-5 against the XLA segment-sums (the same per-bin doc
order) and to the Pallas kernel's own tolerance (atol 2e-4, rtol 1e-5: it
reassociates). On the CPU the wrapper takes its plain version; the CUDA
kernel is held to it on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ranklib_tpu.ops.histogram import hist_multi_pallas, hist_multi_xla
from ranklib_tpu_torch.ops import histogram as H
from ranklib_tpu_torch.utils.errors import RankLibError
from tests.test_torch_histogram import emulate


def _case(N, F, B, C, seed, dtype=np.int32, over=0):
    """ids in [0, B + over) (clipped to the type), grads N(0,1), and
    multiplicities 0-3 with one all-zero bag."""
    rng = np.random.default_rng(seed)
    top = min(B + over, np.iinfo(dtype).max + 1)
    binned = rng.integers(0, top, size=(F, N)).astype(dtype)
    grads = rng.normal(size=(C, N)).astype(np.float32)
    w = rng.integers(0, 4, size=(C, N)).astype(np.float32)
    w[C // 2] = 0.0
    return binned, grads, w


def _port(binned, grads, w, B):
    return H.histogram_multi(torch.from_numpy(binned).contiguous(),
                             torch.from_numpy(grads), torch.from_numpy(w),
                             B).numpy()


@pytest.mark.parametrize("N,F,B,C", [
    (400, 5, 16, 4), (300, 6, 8, 1), (257, 7, 11, 3), (700, 9, 256, 8),
])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32])
def test_plain_matches_hist_multi_xla(N, F, B, C, dtype):
    binned, grads, w = _case(N, F, B, C, seed=N + C, dtype=dtype, over=3)
    want = np.asarray(hist_multi_xla(jnp.asarray(binned), jnp.asarray(grads),
                                     jnp.asarray(w), B))
    got = _port(binned, grads, w, B)
    assert got.shape == want.shape == (C, F, B, 2)
    np.testing.assert_array_equal(got[..., 1], want[..., 1])
    np.testing.assert_allclose(got[..., 0], want[..., 0], atol=1e-5,
                               rtol=1e-5)
    assert not got[C // 2].any()                     # the all-zero bag


@pytest.mark.parametrize("C", [1, 3, 8])
def test_plain_matches_reference_pallas_kernel(C):
    """The reference's own multi-bag kernel test shape (N 900, F 7,
    B 128), int32 ids, in TPU interpret mode."""
    binned, grads, w = _case(900, 7, 128, C, seed=11 + C)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(hist_multi_pallas(
            jnp.asarray(binned), jnp.asarray(grads), jnp.asarray(w), 128))
    got = _port(binned, grads, w, 128)
    np.testing.assert_array_equal(got[..., 1], want[..., 1])
    np.testing.assert_allclose(got[..., 0], want[..., 0], atol=2e-4,
                               rtol=1e-5)


def test_bags_are_independent_single_histograms():
    binned, grads, w = _case(500, 6, 32, 5, seed=3, dtype=np.uint8, over=2)
    got = _port(binned, grads, w > 1, 32)             # bool weights
    for c in range(5):
        want = H.histogram(torch.from_numpy(binned), torch.from_numpy(
            grads[c]), torch.from_numpy(w[c] > 1), 32).numpy()
        np.testing.assert_array_equal(got[c], want)


def test_multi_tiles_fit_the_shared_memory_budget():
    """The multi-bag plan: a warp a (bag, 32-feature group) at 256 bins,
    one slice when the warps fill the card, more ranges for wide bins;
    every plan fits a block."""
    p = H.plan(136, 256, 300, 180224)
    assert (p.ranges, p.slices, p.grid) == (1, 1, (1, 5, 300))
    assert H.plan(6, 256, 2, 300).grid == (1, 1, 2)
    assert H.plan(136, 4096, 64, 180224).ranges == 16
    assert H.plan(9, 11, 64, 300).warp_bins == 11
    for F, B, C in [(136, 256, 300), (3, 11, 1), (40, 1024, 9),
                    (9, 11, 64)]:
        assert H.plan(F, B, C, 5000).smem <= 232448


def _coverage(p, F, B, C, N):
    """How often the kernel's grid (as csrc/histogram_common.cuh indexes
    it) covers each bag, feature, bin and document. The grid is a product
    of (slice) x (feature group, range) x (bag) with 32 lanes a feature
    group, so each factor is counted apart."""
    bags = np.zeros(C, int)
    for z in range(p.grid[2]):
        if z < C:
            bags[z] += 1
    feats = np.zeros(F, int)
    bins = np.zeros(B, int)
    for y in range(p.grid[1]):
        r, fg = y % p.ranges, y // p.ranges
        if fg == 0:
            lo = r * p.warp_bins
            bins[lo:lo + min(p.warp_bins, B - lo)] += 1
        if r == 0:
            feats[fg * 32:min(F, fg * 32 + 32)] += 1
    docs = np.zeros(N, int)
    for x in range(p.grid[0]):
        docs[x * p.slice_len:min(N, (x + 1) * p.slice_len)] += 1
    return bags, feats, bins, docs


@pytest.mark.parametrize("C", [1, 3, 32, 300, 312])
@pytest.mark.parametrize("B", [1, 8, 11, 256, 512, 1024, 40000])
def test_plan_covers_every_cell_once_and_fits(B, C):
    """Every (bag, feature, bin, document) is covered exactly once, for
    any B and C, and the block fits the card's 232,448 bytes."""
    F, N = 37, 5000
    p = H.plan(F, B, C, N)
    assert p.smem <= 232448
    assert p.slice_len % 128 == 0 and p.warp_bins <= 256
    for counts in _coverage(p, F, B, C, N):
        assert (counts == 1).all()


@pytest.mark.parametrize("N,F,B,C,dtype", [
    (5000, 7, 256, 5, np.uint8), (3000, 40, 11, 3, np.int16),
    (2100, 5, 300, 4, np.int32),
])
def test_kernel_summation_order_matches_plain_and_reference(N, F, B, C,
                                                            dtype):
    """The kernel's order (each bag's weighted documents in order within
    a slice, slices in order) against the plain version and the
    reference's hist_multi_xla: counts exact, sums within the card's
    tolerance (atol 2e-4, rtol 1e-5)."""
    binned, grads, w = _case(N, F, B, C, seed=N + C, dtype=dtype, over=3)
    p = H.plan(F, B, C, N)
    got = emulate(binned, grads, w, B, p)
    for want in (_port(binned, grads, w, B),
                 np.asarray(hist_multi_xla(jnp.asarray(binned),
                                           jnp.asarray(grads),
                                           jnp.asarray(w), B))):
        np.testing.assert_array_equal(got[..., 1], want[..., 1])
        np.testing.assert_allclose(got[..., 0], want[..., 0], atol=2e-4,
                                   rtol=1e-5)


def test_wrapper_checks_inputs_and_counts_only_kernel_launches():
    binned, grads, w = _case(64, 3, 8, 2, seed=5, dtype=np.uint8)
    ids, g, wt = (torch.from_numpy(binned), torch.from_numpy(grads),
                  torch.from_numpy(w))
    before = H.histogram_multi.launches
    H.histogram_multi(ids, g, wt, 8)
    assert H.histogram_multi.launches == before      # CPU: plain version
    empty = H.histogram_multi(ids, g[:0], wt[:0], 8)
    assert empty.shape == (0, 3, 8, 2)
    bad = [
        lambda: H.histogram_multi(ids.to(torch.int64), g, wt, 8),
        lambda: H.histogram_multi(ids.T.contiguous().T, g, wt, 8),
        lambda: H.histogram_multi(ids, g[:, :10], wt, 8),
        lambda: H.histogram_multi(ids, g, wt[:1], 8),
        lambda: H.histogram_multi(ids, g.double(), wt, 8),
        lambda: H.histogram_multi(ids, g, wt.to(torch.int32), 8),
        # neither CPU nor CUDA: raises, never falls back to the plain path
        lambda: H.histogram_multi(ids.to("meta"), g.to("meta"),
                                  wt.to("meta"), 8),
    ]
    for call in bad:
        with pytest.raises(RankLibError):
            call()
