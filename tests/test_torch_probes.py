"""The compiler probes' plain versions (ranklib_tpu_torch.tools.probes),
exact against numpy int64 on the CPU.

The reference's probes (tools/exp_int8_dot_probe.py,
tools/exp_mosaic_reprobe.py) need a TPU and print timings only, so the
port's are held to integer arithmetic: an int8 and an f32 product of 0/1
matrices, whose every sum is an integer, and the int16 compare. The CUDA
kernels run on a card through ``python -m ranklib_tpu_torch.tools.probes``
and chip_smoke.py, which hold them to these plain versions.
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


def test_main_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probes would run")
    assert P.main(["--k", "64"]) == 2
    assert "CUDA is not available" in capsys.readouterr().err
