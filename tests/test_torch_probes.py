"""The compiler probes' plain versions (ranklib_tpu_torch.tools.probes),
exact against numpy int64 on the CPU.

The reference's probes (tools/exp_int8_dot_probe.py,
tools/exp_mosaic_reprobe.py) need a TPU and print timings only, so the
port's are held to integer arithmetic: an int8 and an f32 product of 0/1
matrices, whose every sum is an integer, and the int16 compare. The CUDA
kernels run on a card through ``python -m ranklib_tpu_torch.tools.probes``
and chip_smoke.py, which hold them to these plain versions; here a numpy
emulation of the int8 kernel's B staging (the prmt byte transpose into a
swizzled K-major tile) is held to bᵀ at odd N and K.
"""

import numpy as np
import pytest
import torch

from ranklib_tpu_torch.tools import probes as P
from ranklib_tpu_torch.utils.errors import RankLibError

CPU = torch.device("cpu")


@pytest.mark.parametrize("k", [1, 7, 4096, 20000])
def test_dot_plain_is_exact(k):
    a, b = P.probe_inputs(k, CPU, seed=k)
    assert a.shape == (P.PROBE_M, k) and b.shape == (k, P.PROBE_N)
    want = a.numpy().astype(np.int64) @ b.numpy().astype(np.int64)
    got8 = P.dot(a, b)
    got32 = P.dot(a.float(), b.float())
    assert got8.dtype == torch.int32 and got32.dtype == torch.float32
    np.testing.assert_array_equal(got8.numpy(), want)
    np.testing.assert_array_equal(got32.numpy(), want.astype(np.float32))
    assert int(got8.to(torch.int64).sum()) == int(want.sum())


def test_dot_plain_with_signed_int8():
    rng = np.random.default_rng(3)
    a = rng.integers(-128, 128, size=(19, 33)).astype(np.int8)
    b = rng.integers(-128, 128, size=(33, 5)).astype(np.int8)
    np.testing.assert_array_equal(
        P.dot_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        a.astype(np.int64) @ b.astype(np.int64))


def test_compare_plain_is_exact():
    x = P.compare_input(CPU)
    assert x.dtype == torch.int16 and x.shape == (8, 128)
    want = (x.numpy().astype(np.int64) > 3).astype(np.float32)
    np.testing.assert_array_equal(P.compare(x).numpy(), want)
    assert float(P.compare(x).sum()) == float(want.sum())
    wide = torch.from_numpy(np.arange(-40000, 40000, 7).astype(np.int16))
    np.testing.assert_array_equal(
        P.compare(wide, threshold=-5).numpy(),
        (wide.numpy().astype(np.int64) > -5).astype(np.float32))


def test_wrappers_check_inputs_and_count_only_kernel_launches():
    a, b = P.probe_inputs(16, CPU)
    before = (P.dot.launches, P.compare.launches)
    P.dot(a, b)
    P.compare(P.compare_input(CPU))
    assert (P.dot.launches, P.compare.launches) == before   # CPU: plain
    bad = [
        lambda: P.dot(a, b.float()),
        lambda: P.dot(a.to(torch.int16), b.to(torch.int16)),
        lambda: P.dot(a, b[:3]),
        lambda: P.dot(a.T.contiguous().T, b),
        lambda: P.dot(a.to("meta"), b.to("meta")),
        lambda: P.compare(P.compare_input(CPU).to(torch.int32)),
        lambda: P.compare(P.compare_input(CPU).to("meta")),
    ]
    for call in bad:
        with pytest.raises(RankLibError):
            call()


def _prmt(a, b, sel):
    """PTX prmt / __byte_perm: byte i of the result is byte (sel >> 4i) & 7
    of b:a."""
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] + \
          [(b >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _transpose4x4(x):
    """csrc/probes.cu transpose4x4: x[r] = bytes (row r, cols 0..3) ->
    out[c] = bytes (rows 0..3, col c)."""
    t0, t1 = _prmt(x[0], x[1], 0x5140), _prmt(x[0], x[1], 0x7362)
    t2, t3 = _prmt(x[2], x[3], 0x5140), _prmt(x[2], x[3], 0x7362)
    return [_prmt(t0, t2, 0x5410), _prmt(t0, t2, 0x7632),
            _prmt(t1, t3, 0x5410), _prmt(t1, t3, 0x7632)]


def _stage_b_tile(b, k0, n0):
    """csrc/probes.cu I8Stage::load_b + store_b for one [64 k, 128 n] tile
    of b [K, N] int8, in numpy: thread tid loads rows k0 + (tid % 16)·4 +
    r, columns n0 + (tid / 16)·8 .. +7 (zeros past K and N), transposes the
    two 4 x 4 byte blocks and stores column n's 4 bytes at (row n, k byte
    (tid % 16)·4) of the [128 n][64 k] tile, its 16-byte chunks swizzled
    by (n / 2) % 4. Returns that tile, unswizzled, as [128, 64] int8."""
    K, N = b.shape
    u = b.view(np.uint8).astype(np.int64)
    smem = np.zeros(128 * 64, np.uint8)
    for tid in range(256):
        k4, nb = tid & 15, tid >> 4
        rows = []
        for r in range(4):
            gk = k0 + k4 * 4 + r
            w = [0, 0]
            for j in range(8):
                if gk < K and n0 + nb * 8 + j < N:
                    w[j >> 2] |= int(u[gk, n0 + nb * 8 + j]) << (8 * (j & 3))
            rows.append(w)
        t = _transpose4x4([w[0] for w in rows]) + \
            _transpose4x4([w[1] for w in rows])
        for j in range(8):
            n = nb * 8 + j
            c = k4 >> 2
            off = n * 64 + ((c ^ ((n >> 1) & 3)) << 4) + (k4 & 3) * 4
            smem[off:off + 4] = np.frombuffer(
                int(t[j]).to_bytes(4, "little"), np.uint8)
    tile = np.zeros((128, 64), np.uint8)
    for n in range(128):
        for c in range(4):
            off = n * 64 + ((c ^ ((n >> 1) & 3)) << 4)
            tile[n, c * 16:(c + 1) * 16] = smem[off:off + 16]
    return tile.view(np.int8)


@pytest.mark.parametrize("K, N, k0, n0", [(33, 7, 0, 0), (131, 129, 64, 128),
                                          (4097, 1, 4096, 0),
                                          (100, 200, 64, 0)])
def test_int8_kernel_stages_b_k_major(K, N, k0, n0):
    """The int8 kernel's B staging, emulated: the tile it leaves in shared
    memory is bᵀ's [n0:n0+128, k0:k0+64] block, zero past N and K, for
    signed bytes at odd N and K."""
    rng = np.random.default_rng(K + N)
    b = rng.integers(-128, 128, (K, N)).astype(np.int8)
    want = np.zeros((128, 64), np.int8)
    blk = b.T[n0:n0 + 128, k0:k0 + 64]
    want[:blk.shape[0], :blk.shape[1]] = blk
    np.testing.assert_array_equal(_stage_b_tile(b, k0, n0), want)


def test_main_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probes would run")
    assert P.main(["--k", "64"]) == 2
    assert "CUDA is not available" in capsys.readouterr().err
