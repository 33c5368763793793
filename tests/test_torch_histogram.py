"""The port's histogram (ranklib_tpu_torch.ops.histogram) against the
reference's ``hist_xla`` and, in TPU interpret mode, its radix Pallas
kernel.

Same numpy-seeded inputs through both packages. Counts (sums of 0/1 or
integer weights) must be exactly equal; gradient sums agree to 1e-5
against the XLA segment-sum (the same per-bin doc order) and to the radix
kernel's own tolerance (atol 2e-4, rtol 1e-5: it reassociates). On the
CPU the port's wrapper takes its plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ranklib_tpu.ops.histogram import hist_pallas_radix, hist_xla
from ranklib_tpu_torch.ops.histogram import (
    histogram, histogram_multi_plain, histogram_plain, plan,
)
from ranklib_tpu_torch.utils.errors import RankLibError

DTYPES = {np.uint8: torch.uint8, np.int16: torch.int16,
          np.int32: torch.int32}


def _case(N, F, B, seed, dtype=np.int32, weights="bool", over=0):
    """ids in [0, B + over) (clipped to the type), grad N(0,1), and a
    bool mask, f32 multiplicities or all-zero weights."""
    rng = np.random.default_rng(seed)
    top = min(B + over, np.iinfo(dtype).max + 1)
    binned = rng.integers(0, top, size=(F, N)).astype(dtype)
    grad = rng.normal(size=N).astype(np.float32)
    if weights == "bool":
        w = rng.random(N) > 0.3
    elif weights == "mult":
        w = rng.integers(0, 4, size=N).astype(np.float32)
    else:
        w = np.zeros(N, np.float32)
    return binned, grad, w


def _port(binned, grad, w, B):
    return histogram(torch.from_numpy(binned).contiguous(),
                     torch.from_numpy(grad), torch.from_numpy(w), B).numpy()


@pytest.mark.parametrize("N,F,B", [
    (512, 8, 8), (300, 6, 8), (1024, 17, 128), (700, 9, 256), (257, 5, 11),
])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32])
@pytest.mark.parametrize("weights", ["bool", "mult"])
def test_plain_matches_hist_xla(N, F, B, dtype, weights):
    binned, grad, w = _case(N, F, B, seed=N + F, dtype=dtype,
                            weights=weights, over=3)
    want = np.asarray(hist_xla(jnp.asarray(binned), grad, w, B))
    got = _port(binned, grad, w, B)
    assert got.shape == want.shape == (F, B, 2)
    np.testing.assert_array_equal(got[..., 1], want[..., 1])
    np.testing.assert_allclose(got[..., 0], want[..., 0], atol=1e-5)


@pytest.mark.parametrize("N,F", [(512, 8), (700, 9)])
def test_plain_matches_radix_kernel(N, F):
    binned, grad, w = _case(N, F, 256, seed=N + F)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(hist_pallas_radix(jnp.asarray(binned), grad, w,
                                            256))
    got = _port(binned, grad, w, 256)
    np.testing.assert_array_equal(got[..., 1], want[..., 1])
    np.testing.assert_allclose(got[..., 0], want[..., 0], atol=2e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("weights", ["bool", "mult"])
def test_negative_ids_add_nothing_as_in_the_radix_kernel(weights):
    """int32 ids in [-3, 260) at B = 256, feature 0 included (where a
    negative flat index once made ``index_add_`` raise): the plain
    versions drop ids < 0 as the reference's radix kernel does in
    interpret mode (its ``hist_xla`` would move them into the previous
    feature's top bins)."""
    rng = np.random.default_rng(41)
    N, F, B = 600, 5, 256
    binned = rng.integers(-3, 260, size=(F, N)).astype(np.int32)
    binned[0, :40] = -1
    _, grad, w = _case(N, F, B, seed=43, weights=weights)
    w = w.astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(hist_pallas_radix(jnp.asarray(binned), grad, w, B))
    got = _port(binned, grad, w, B)
    np.testing.assert_array_equal(got[..., 1], want[..., 1])
    np.testing.assert_allclose(got[..., 0], want[..., 0], atol=2e-4,
                               rtol=1e-5)
    keep = (binned >= 0) & (binned < B)
    np.testing.assert_array_equal(got[..., 1].sum(axis=1),
                                  (keep * w[None]).sum(axis=1))
    grads = np.stack([grad, -grad]).astype(np.float32)
    ws = np.stack([w, w[::-1]]).astype(np.float32)
    multi = histogram_multi_plain(torch.from_numpy(binned),
                                  torch.from_numpy(grads),
                                  torch.from_numpy(ws), B).numpy()
    for c in range(2):
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(hist_pallas_radix(jnp.asarray(binned),
                                                grads[c], ws[c], B))
        np.testing.assert_array_equal(multi[c, ..., 1], want[..., 1])
        np.testing.assert_allclose(multi[c, ..., 0], want[..., 0],
                                   atol=2e-4, rtol=1e-5)


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32])
def test_all_zero_weights_give_zero(dtype):
    binned, grad, w = _case(300, 4, 8, seed=0, dtype=dtype, weights="zero")
    assert not _port(binned, grad, w, 8).any()


def test_ids_at_or_above_b_add_nothing():
    """uint8 ids at B = 256 cannot exceed it; int16 ids of NaN features
    reach exactly 256 and must be dropped, not wrapped into bin 0."""
    binned = np.array([[0, 7, 8, 9], [255, 256, 300, 1]], np.int16)
    grad = np.ones(4, np.float32)
    w = np.ones(4, np.float32)
    h8 = _port(binned[:1], grad, w, 8)
    assert h8[0, 0, 1] == 1 and h8[0, 7, 1] == 1 and h8[..., 1].sum() == 2
    h256 = _port(binned[1:], grad, w, 256)
    assert h256[0, 255, 1] == 1 and h256[0, 1, 1] == 1
    assert h256[..., 1].sum() == 2


def test_wrapper_checks_its_inputs():
    b = torch.zeros((2, 5), dtype=torch.int64)
    g, m = torch.zeros(5), torch.ones(5, dtype=torch.bool)
    with pytest.raises(RankLibError, match="uint8, int16 or int32"):
        histogram(b, g, m, 8)
    with pytest.raises(RankLibError, match="contiguous"):
        histogram(torch.zeros((5, 2), dtype=torch.int32).T, g, m, 8)
    with pytest.raises(RankLibError, match=r"\[5\]"):
        histogram(b.to(torch.int32), g[:4], m, 8)
    with pytest.raises(RankLibError, match="float32"):
        histogram(b.to(torch.int32), g.double(), m, 8)


def test_feature_grouping_fits_shared_memory():
    """The CUDA launch's plan for one weight vector: a warp of 32 features
    over all 256 bins at the training width, in enough document slices
    that three warps on each of 132 SMs are busy; narrow bins take less
    shared memory, wide bins more ranges, and every plan fits a block's
    232,448 bytes."""
    p = plan(136, 256, 1, 180224)
    assert (p.warp_bins, p.ranges, p.slices, p.slice_len) == (256, 1, 79,
                                                              2304)
    assert p.grid == (79, 5, 1) and p.smem == 73984
    assert plan(136, 8, 1, 180224).smem < plan(136, 256, 1, 180224).smem
    assert plan(5, 8, 1, 300).grid == (1, 1, 1)
    assert plan(136, 1024, 1, 180224).ranges == 4
    p = plan(3, 40000, 1, 100)
    assert (p.warp_bins, p.ranges, p.smem) == (256, 157, 73984)


def _slices(p, N):
    return [(x * p.slice_len, min(N, (x + 1) * p.slice_len))
            for x in range(p.slices)]


def emulate(binned, grads, w, B, p, features=None):
    """numpy emulation of the column kernel's summation order under plan
    ``p``: per slice, each (bag, feature) column adds its weighted
    documents' (g·w, w) in document order (f32, ids outside [0, B)
    skipped); the slices' partials are added in slice order. ``grads`` and
    ``w`` are [C, N]; ``features`` [C, Fs] (-1 pads) keeps bag c's columns
    to those its row lists, the others zero."""
    F, N = binned.shape
    C = grads.shape[0]
    out = np.zeros((C, F, B, 2), np.float32)
    for lo, hi in _slices(p, N):
        part = np.zeros((C, F, B, 2), np.float32)
        for c in range(C):
            d = np.arange(lo, hi)
            d = d[w[c, lo:hi] != 0]
            gw = (grads[c, d] * w[c, d]).astype(np.float32)
            for f in (range(F) if features is None
                      else features[c][features[c] >= 0]):
                ids = binned[f, d].astype(np.int64)
                keep = (ids >= 0) & (ids < B)
                # np.add.at adds in index order: the lane's document order
                np.add.at(part[c, f, :, 0], ids[keep], gw[keep])
                np.add.at(part[c, f, :, 1], ids[keep], w[c, d][keep])
        out += part
    return out


def lane_sums(bins_col, gw, w, n_bins, unroll=4):
    """One lane's column as the kernel sums it: items four at a time, cells
    loaded together, an item whose bin equals an earlier one of the four
    taking that one's running sum, cells stored in order."""
    h = np.zeros((n_bins, 2), np.float32)
    for k in range(0, len(bins_col), unroll):
        b = [int(x) if 0 <= x < n_bins else -1
             for x in bins_col[k:k + unroll]]
        v = [h[max(x, 0)].copy() for x in b]
        for u in range(len(b)):
            for j in range(u):
                if b[j] == b[u]:
                    v[u] = v[j].copy()
            v[u][0] = np.float32(v[u][0] + gw[k + u])
            v[u][1] = np.float32(v[u][1] + w[k + u])
        for u, x in enumerate(b):
            if x >= 0:
                h[x] = v[u]
    return h


def test_forwarded_groups_equal_the_sequential_sum():
    """The four-at-a-time read-modify-write with forwarding gives the bits
    of adding one document at a time, on bins that repeat inside a group."""
    rng = np.random.default_rng(3)
    bins_col = rng.integers(-1, 6, size=203)
    gw = rng.normal(size=203).astype(np.float32)
    w = rng.integers(1, 4, size=203).astype(np.float32)
    want = np.zeros((5, 2), np.float32)
    keep = (bins_col >= 0) & (bins_col < 5)
    np.add.at(want[:, 0], bins_col[keep], gw[keep])
    np.add.at(want[:, 1], bins_col[keep], w[keep])
    np.testing.assert_array_equal(lane_sums(bins_col, gw, w, 5), want)


@pytest.mark.parametrize("N,F,B,dtype,weights", [
    (5000, 13, 256, np.uint8, "bool"), (9000, 5, 11, np.int16, "mult"),
    (4100, 9, 512, np.int32, "bool"), (300, 6, 8, np.uint8, "mult"),
])
def test_kernel_summation_order_matches_plain_and_reference(N, F, B, dtype,
                                                            weights):
    """The kernel's order (slices of the plan, documents in order within
    a slice) against the plain version and the reference's hist_xla:
    counts exact, sums within the card's tolerance (atol 2e-4, rtol
    1e-5)."""
    binned, grad, w = _case(N, F, B, seed=N + B, dtype=dtype,
                            weights=weights, over=3)
    w = w.astype(np.float32)
    p = plan(F, B, 1, N)
    got = emulate(binned, grad[None], w[None], B, p)[0]
    for want in (_port(binned, grad, w, B),
                 np.asarray(hist_xla(jnp.asarray(binned), grad, w, B))):
        np.testing.assert_array_equal(got[..., 1], want[..., 1])
        np.testing.assert_allclose(got[..., 0], want[..., 0], atol=2e-4,
                                   rtol=1e-5)


def test_subtraction_trick():
    """parent − right child == left child, the identity growth relies on."""
    rng = np.random.default_rng(7)
    binned = rng.integers(0, 8, size=(5, 512)).astype(np.uint8)
    grad = rng.normal(size=512).astype(np.float32)
    parent = rng.random(512) > 0.2
    right = parent & (rng.random(512) > 0.5)
    h = {k: histogram_plain(torch.from_numpy(binned), torch.from_numpy(grad),
                            torch.from_numpy(v), 8)
         for k, v in (("p", parent), ("r", right), ("l", parent & ~right))}
    torch.testing.assert_close(h["p"] - h["r"], h["l"], atol=1e-4, rtol=0)
