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
    feats_per_block, histogram, histogram_plain,
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
    """The CUDA launch's feature groups: ≤ 32 features, ≤ 64 KB of
    histograms a block, at least one feature."""
    assert feats_per_block(136, 256) == 32
    assert feats_per_block(136, 8) == 32
    assert feats_per_block(5, 8) == 5
    assert feats_per_block(136, 1024) == 8
    assert feats_per_block(3, 40000) == 1


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
