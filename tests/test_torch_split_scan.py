"""The port's best-split scan (ranklib_tpu_torch.ops.split_scan) against the
reference's ``best_splits_xla`` and, in TPU interpret mode, its Pallas
row scan.

Integer-valued histograms make every prefix sum exact, so picks must be
equal — ties included (the feature-major first max). Float histograms
match gains to rtol 1e-5. :func:`kernel_order` emulates the CUDA kernel's
own order of additions (csrc/split_scan.cu: lane-serial prefixes over K
contiguous bins, a Hillis-Steele warp scan of the lane totals, passes of
32·K bins with a carry) and its per-node first max, so the kernel's
arithmetic is held to the plain version here, where there is no card.
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


def _plant_ties(hist):
    """Feature 4 repeats feature 1 (a cross-feature tie) and feature 6 has
    all-zero sums (every valid bin of it ties)."""
    hist = hist.copy()
    hist[:, 4] = hist[:, 1]
    hist[:, 6, :, 0] = 0.0
    return hist


def _prefix_pass(c, s, carry_c, carry_s):
    """One pass of the kernel's prefix over ``c, s [..., 32, K]`` (lane,
    bin of the lane) in its f32 order; returns the prefixes and the new
    carries (the prefix at the pass's last bin)."""
    c, s = c.clone(), s.clone()
    K = c.shape[-1]
    for j in range(1, K):                        # lane-serial
        c[..., j] = c[..., j - 1] + c[..., j]
        s[..., j] = s[..., j - 1] + s[..., j]
    tc, ts = c[..., K - 1].clone(), s[..., K - 1].clone()
    off = 1
    while off < 32:                              # Hillis-Steele warp scan
        tc = torch.cat([tc[..., :off], tc[..., :-off] + tc[..., off:]], -1)
        ts = torch.cat([ts[..., :off], ts[..., :-off] + ts[..., off:]], -1)
        off *= 2
    ec = torch.cat([torch.zeros_like(tc[..., :1]), tc[..., :-1]], -1)
    es = torch.cat([torch.zeros_like(ts[..., :1]), ts[..., :-1]], -1)
    c = (carry_c[..., None] + ec)[..., None] + c
    s = (carry_s[..., None] + es)[..., None] + s
    return c, s, c[..., 31, K - 1], s[..., 31, K - 1]


def kernel_order(hist, mls, fmask=None):
    """torch emulation of csrc/split_scan.cu on ``hist [Cn, F, B, 2]``:
    passes of 32·K bins (K the least power of two with 32·K ≥ B, at most
    16; a first run of the passes for the total when there are several),
    the gain in f32, each row's first max over bins, then each node's
    first max over features; nothing valid → (-inf, 0, 0, False)."""
    hist = torch.as_tensor(hist)
    Cn, F, B, _ = hist.shape
    K = 1
    while K < 16 and 32 * K < B:
        K *= 2
    P = -(-B // (32 * K))
    pad = torch.zeros((Cn, F, P * 32 * K, 2), dtype=torch.float32)
    pad[:, :, :B] = hist
    s_all = pad[..., 0].reshape(Cn, F, P, 32, K)
    c_all = pad[..., 1].reshape(Cn, F, P, 32, K)
    zero = torch.zeros((Cn, F), dtype=torch.float32)
    tot_c, tot_s = zero, zero
    if P > 1:
        for q in range(P):
            *_, tot_c, tot_s = _prefix_pass(c_all[:, :, q], s_all[:, :, q],
                                            tot_c, tot_s)
    cc, cs, cl, sl = zero, zero, [], []
    for q in range(P):
        c, s, cc, cs = _prefix_pass(c_all[:, :, q], s_all[:, :, q], cc, cs)
        cl.append(c)
        sl.append(s)
    if P == 1:
        tot_c, tot_s = cc, cs
    c_l = torch.stack(cl, 2).reshape(Cn, F, -1)
    s_l = torch.stack(sl, 2).reshape(Cn, F, -1)
    c_r = tot_c[..., None] - c_l
    s_r = tot_s[..., None] - s_l
    mls = max(float(mls), 1e-9)
    ok = (torch.arange(c_l.shape[-1]) < B) & (c_l >= mls) & (c_r >= mls)
    if fmask is not None:
        ok = ok & torch.as_tensor(fmask)[:, :, None]
    gain = torch.where(ok, s_l * s_l / torch.clamp(c_l, min=1.0)
                       + s_r * s_r / torch.clamp(c_r, min=1.0), -torch.inf)
    row_b = torch.argmax(gain, dim=2)
    row_g = torch.gather(gain, 2, row_b[..., None])[..., 0]
    f = torch.argmax(row_g, dim=1)
    g = torch.gather(row_g, 1, f[:, None])[:, 0]
    b = torch.gather(row_b, 1, f[:, None])[:, 0]
    anyv = g > -torch.inf
    return (g, torch.where(anyv, f, 0).to(torch.int32),
            torch.where(anyv, b, 0).to(torch.int32), torch.isfinite(g))


def _both(hist, mls, fmask=None, route="wrapper"):
    want = best_splits_xla(jnp.asarray(hist), mls,
                           None if fmask is None else jnp.asarray(fmask))
    fm = None if fmask is None else torch.from_numpy(fmask)
    if route == "wrapper":
        got = best_splits(torch.from_numpy(hist), mls, fm)
    else:
        got = kernel_order(torch.from_numpy(hist), mls, fm)
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


@pytest.mark.parametrize("Cn,B", [(1, 8), (2, 11), (1, 256), (2, 256),
                                  (2, 512)])
@pytest.mark.parametrize("mls", [0.0, 1.0, 3.0])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("route", ["wrapper", "kernel order"])
def test_integer_histograms_pick_exactly(Cn, B, mls, masked, route):
    """Both the CPU route and the kernel's emulated order equal the
    reference exactly, with planted ties and empty sides at -mls 0."""
    hist = _plant_ties(_hist(Cn, 7, B, seed=B + Cn, empty_child=(Cn == 2)))
    fmask = (np.random.default_rng(B).random((Cn, 7)) > 0.4
             if masked else None)
    want, got = _both(hist, mls, fmask, route)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    plain = best_splits_plain(torch.from_numpy(hist), mls,
                              None if fmask is None
                              else torch.from_numpy(fmask))
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, p.numpy())


def test_float_histograms_match_gains():
    hist = _hist(2, 9, 256, seed=4, integer=False)
    want, got = _both(hist, 1.0)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_array_equal(got[1:], want[1:])


@pytest.mark.parametrize("B", [8, 11, 256, 512, 1100])
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_order_on_float_histograms(B, masked):
    """The kernel's order on float histograms: gains within rtol 1e-5 of
    the plain version, the same ok flags, and the same (feature, bin)
    wherever the best gain leads the runner-up by more than that; B = 1100
    takes three passes."""
    Cn, F = 3, 9
    hist = torch.from_numpy(_hist(Cn, F, B, seed=B, integer=False))
    fm = (torch.from_numpy(np.random.default_rng(B + 1).random((Cn, F))
                           > 0.3) if masked else None)
    got = kernel_order(hist, 1.0, fm)
    want = best_splits_plain(hist, 1.0, fm)
    assert torch.equal(got[3], want[3])
    fin = torch.isfinite(want[0])
    torch.testing.assert_close(got[0][fin], want[0][fin], rtol=1e-5, atol=0)
    c_l = torch.cumsum(hist[..., 1].double(), 2)
    s_l = torch.cumsum(hist[..., 0].double(), 2)
    c_r, s_r = c_l[..., -1:] - c_l, s_l[..., -1:] - s_l
    ok = (c_l >= 1) & (c_r >= 1)
    if fm is not None:
        ok = ok & fm[:, :, None]
    flat = torch.where(ok, s_l ** 2 / c_l.clamp(min=1) + s_r ** 2
                       / c_r.clamp(min=1), -torch.inf).reshape(Cn, -1)
    top2 = torch.topk(flat, 2, dim=1).values
    clear = fin & (top2[:, 0] - top2[:, 1] > 1e-5 * top2[:, 0].abs())
    assert clear.any()
    for i in torch.nonzero(clear).flatten():
        assert (int(got[1][i]), int(got[2][i])) == (int(want[1][i]),
                                                     int(want[2][i]))


@pytest.mark.parametrize("n_first", [1, 2])
@pytest.mark.parametrize("masked", [False, True])
def test_pair_form_equals_the_stacked_form(n_first, masked):
    """Growth passes its two children as a pair: the same answers as the
    stacked tensor, with one mask row for every node or one a node."""
    hist = torch.from_numpy(_plant_ties(_hist(2 * n_first, 7, 256, seed=9)))
    pair = (hist[:n_first].contiguous(), hist[n_first:].contiguous())
    fm = None
    if masked:
        row = torch.from_numpy(np.random.default_rng(3).random(7) > 0.4)
        fm = row.expand(2 * n_first, 7)
    for a, b in zip(best_splits(pair, 1.0, fm), best_splits(hist, 1.0, fm)):
        assert torch.equal(a, b)
    for a, b in zip(kernel_order(torch.cat(pair), 1.0, fm),
                    best_splits(pair, 1.0, fm)):
        assert torch.equal(a, b)


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
    with pytest.raises(RankLibError, match="share F, B"):
        best_splits((hist, hist[:, :2].contiguous()), 1.0)
    with pytest.raises(RankLibError, match="one tensor or a pair"):
        best_splits((hist, hist, hist), 1.0)
