"""The port's multi-bag histogram (ranklib_tpu_torch.ops.histogram
``histogram_multi``) against the reference's ``hist_multi_xla`` and, in
TPU interpret mode, its ``hist_multi_pallas`` kernel.

Same numpy-seeded ids, gradients and bag weights through both packages.
Counts (sums of integer multiplicities) must be exactly equal; gradient
sums agree to 1e-5 against the XLA segment-sums (the same per-bin doc
order) and to the Pallas kernel's own tolerance (atol 2e-4, rtol 1e-5: it
reassociates). On the CPU the wrapper takes its plain version; the CUDA
kernel is held to it on the card by chip_smoke.py. Feature lists (each
bag's sampled features) are held to the list-free call: the same bits in
the listed cells, zeros elsewhere, in the plain version and in the
emulated kernel order, and the plan's grid at the list's width.
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


# ---- feature lists: each bag's sampled features alone ----------------------

def _lists(F, counts, seed):
    """Feature lists of bags holding ``counts[c]`` features drawn without
    replacement, and their [C, F] masks."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((len(counts), F), bool)
    for c, k in enumerate(counts):
        masks[c, rng.choice(F, k, replace=False)] = True
    return H.feature_lists(masks), masks


def _listed(binned, grads, w, B, lists):
    return H.histogram_multi(torch.from_numpy(binned).contiguous(),
                             torch.from_numpy(grads), torch.from_numpy(w), B,
                             features=torch.from_numpy(lists)).numpy()


LIST_CASES = [
    # N, F, B, each bag's count, ids
    (400, 37, 16, (11, 11, 11, 11), np.uint8),    # RF: one count for all
    (700, 40, 256, (12, 3, 0, 40, 7), np.int16),  # ragged, empty, every one
    (2100, 70, 11, (1, 33, 65), np.int32),        # across 32-lane groups
]


@pytest.mark.parametrize("route", ["plain", "emulate"])
@pytest.mark.parametrize("N,F,B,counts,dtype", LIST_CASES)
def test_listed_cells_equal_the_list_free_call(N, F, B, counts, dtype,
                                               route):
    """Listed cells hold the list-free call's bits (the emulation under
    the listed launch's plan); every other cell is +0.0, exactly."""
    C = len(counts)
    binned, grads, w = _case(N, F, B, C, seed=F + C, dtype=dtype, over=3)
    lists, masks = _lists(F, counts, seed=N)
    if route == "plain":
        got = _listed(binned, grads, w, B, lists)
        want = _port(binned, grads, w, B)
    else:
        p = H.plan(F, B, C, N, lists.shape[1])
        got = emulate(binned, grads, w, B, p, lists)
        want = emulate(binned, grads, w, B, p)
    assert got.shape == want.shape == (C, F, B, 2)
    np.testing.assert_array_equal(got[masks], want[masks])
    assert not got[~masks].view(np.int32).any()


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32])
def test_a_list_of_every_feature_is_the_list_free_call(dtype):
    """-frate 1.0: the list covers every feature, and the launch is the
    list-free one (same plan, same bits)."""
    N, F, B, C = 900, 37, 64, 4
    binned, grads, w = _case(N, F, B, C, seed=7, dtype=dtype, over=2)
    lists = H.feature_lists(np.ones((C, F), bool))
    assert lists.tolist() == [list(range(F))] * C
    p = H.plan(F, B, C, N)
    assert H.plan(F, B, C, N, F) == p
    np.testing.assert_array_equal(_listed(binned, grads, w, B, lists),
                                  _port(binned, grads, w, B))
    np.testing.assert_array_equal(emulate(binned, grads, w, B, p, lists),
                                  emulate(binned, grads, w, B, p))


def test_feature_lists_from_masks():
    masks = np.array([[0, 1, 0, 1, 1], [0, 0, 0, 0, 0], [1, 1, 1, 1, 1]],
                     bool)
    assert H.feature_lists(masks).tolist() == [
        [1, 3, 4, -1, -1], [-1] * 5, [0, 1, 2, 3, 4]]
    assert H.feature_lists(masks).dtype == np.int32
    empty = H.feature_lists(np.zeros((2, 4), bool))
    assert empty.shape == (2, 0)
    binned, grads, w = _case(64, 4, 8, 2, seed=2, dtype=np.uint8)
    assert not _listed(binned, grads, w, 8, empty).any()


def test_plan_narrowed_by_a_list_counts_its_warps_in_whole_waves():
    """The RF cells' group shapes (136 features x 2,273,280 docs, 106 and
    88 bags; 700 x 472,656, 66 and 36 bags) at -frate 0.3. A wave is 132
    SMs x 3 warps: 212 warps take 7 slices (4 waves of 1/7 of a walk), 176
    take 2, 462 take 6 (7 whole waves), 252 take 3. Every feature keeps
    the list-free plan."""
    for F, C, N, Fs, grid in [(136, 106, 2273280, 40, (7, 2, 106)),
                              (136, 88, 2273280, 40, (2, 2, 88)),
                              (700, 66, 472656, 210, (6, 7, 66)),
                              (700, 36, 472656, 210, (3, 7, 36))]:
        assert H.plan(F, 256, C, N, Fs).grid == grid
        assert H.plan(F, 256, C, N, F) == H.plan(F, 256, C, N)
        assert H.plan(F, 256, C, N).slices == 1
    assert H.plan(136, 256, 106, 2273280, 40).slice_len == 324864
    assert H.plan(40, 256, 2, 900, 10).slices == 1     # 2,048 docs a slice
    assert H.plan(40, 256, 1, 1 << 20, 10).slices == 8   # _MAX_SLICES


def _listed_writes(p, F, B, C, N, lists):
    """How often a launch of plan ``p`` under ``lists`` (as
    csrc/histogram_common.cuh indexes it) writes each out[c, f, b] cell,
    and walks each (c, f, document) in its first bin range: a listed
    column's lane walks its slice and writes out (one slice) or its
    partial row, which the slice sum adds into out; slice 0's lanes write
    the gaps of unlisted features."""
    Fs = lists.shape[1]

    def listed(c, q):
        return -1 if q < 0 or q >= Fs else int(lists[c, q])

    writes = np.zeros((C, F, B), int)
    walks = np.zeros((C, F, N), int)
    partial = np.zeros((p.slices, C, Fs, B), int)
    for x in range(p.grid[0]):
        docs = slice(x * p.slice_len, min(N, (x + 1) * p.slice_len))
        for y in range(p.grid[1]):
            lo = (y % p.ranges) * p.warp_bins
            bins = slice(lo, lo + min(p.warp_bins, B - lo))
            for c in range(p.grid[2]):
                for lane in range(32):
                    q = (y // p.ranges) * 32 + lane
                    f = listed(c, q)
                    if x == 0 and f >= 0:
                        writes[c, listed(c, q - 1) + 1:f, bins] += 1
                        if listed(c, q + 1) < 0:
                            writes[c, f + 1:, bins] += 1
                    elif x == 0 and q == 0:
                        writes[c, :, bins] += 1
                    if f < 0:
                        continue
                    walks[c, f, docs] += y % p.ranges == 0
                    if p.slices == 1:
                        writes[c, f, bins] += 1
                    else:
                        partial[x, c, q, bins] += 1
    if p.slices > 1:
        assert (partial[:, lists >= 0] == 1).all()
        assert not partial[:, lists < 0].any()
        for c in range(C):
            for q in range(Fs):
                if listed(c, q) >= 0:
                    writes[c, listed(c, q)] += 1
    return writes, walks


@pytest.mark.parametrize("counts", [(11, 11, 11), (12, 3, 0, 37, 7),
                                    (1, 33, 0), (0, 0, 2)])
@pytest.mark.parametrize("B", [8, 256, 300])
def test_plan_covers_every_listed_cell_once_at_the_lists_width(B, counts):
    """Every (bag, listed feature, bin) cell is summed by one lane over
    every document once, every unlisted cell is zeroed once, and the grid
    is ceil(Fs / 32) column groups wide."""
    F, N, C = 37, 5000, len(counts)
    lists, masks = _lists(F, counts, seed=B)
    Fs = lists.shape[1]
    p = H.plan(F, B, C, N, Fs)
    assert p.grid[1] == -(-Fs // 32) * p.ranges and p.grid[2] == C
    assert p.smem <= 232448
    writes, walks = _listed_writes(p, F, B, C, N, lists)
    assert (writes == 1).all()
    assert (walks[masks] == 1).all() and not walks[~masks].any()


_GOOD = [[0, 3, -1], [1, 2, 4]]


@pytest.mark.parametrize("bad", [
    "int64", "one bag", "three dims", "wider than F", "not contiguous",
    "id F", "negative id", "descending", "repeated", "pad inside",
    "on another device"])
def test_wrapper_refuses_a_bad_feature_list(bad):
    binned, grads, w = _case(64, 5, 8, 2, seed=6, dtype=np.uint8)
    ids, g, wt = (torch.from_numpy(binned), torch.from_numpy(grads),
                  torch.from_numpy(w))
    good = torch.tensor(_GOOD, dtype=torch.int32)
    assert H.histogram_multi(ids, g, wt, 8, features=good).shape == (
        2, 5, 8, 2)
    lists = {
        "int64": good.long(), "one bag": good[:1],
        "three dims": good[:, None], "not contiguous": good.T.contiguous().T,
        "wider than F": torch.full((2, 6), -1, dtype=torch.int32),
        "id F": torch.tensor([[0, 5, -1], [1, 2, 4]], dtype=torch.int32),
        "negative id": torch.tensor([[0, -2, -1], [1, 2, 4]],
                                    dtype=torch.int32),
        "descending": torch.tensor([[3, 0, -1], [1, 2, 4]],
                                   dtype=torch.int32),
        "repeated": torch.tensor([[0, 0, -1], [1, 2, 4]], dtype=torch.int32),
        "pad inside": torch.tensor([[0, -1, 3], [1, 2, 4]],
                                   dtype=torch.int32),
        "on another device": good.to("meta"),
    }
    before = (H.histogram_multi.launches, H.histogram_multi.columns)
    with pytest.raises(RankLibError):
        H.histogram_multi(ids, g, wt, 8, features=lists[bad])
    assert (H.histogram_multi.launches, H.histogram_multi.columns) == before
