"""The compiler probes on the card (tools/exp_int8_dot_probe.py and
tools/exp_mosaic_reprobe.py of the reference).

* :func:`dot` replaces ``_kernel_i8`` / ``_kernel_f32`` (``pallas_call``
  at exp_int8_dot_probe.py:68): ``A [M, K] x B [K, N]``, int8 → int32 or
  f32 → f32, one CUDA kernel template (``csrc/probes.cu``) instantiated
  twice;
* :func:`compare` replaces ``kern`` (exp_mosaic_reprobe.py:27): ``x > 3``
  over int16 → f32.

Each has a plain version beside it (:func:`dot_plain`: the product in
float64, exact for integer inputs while every sum stays below 2^53;
:func:`compare_plain`). A CPU tensor takes the plain version, a CUDA tensor
the kernel or the wrapper raises; launches count in ``dot.launches`` and
``compare.launches``. Nothing on a user path calls these: they measure
what a simple hand-written kernel reaches on this card.

Run on a card::

    python -m ranklib_tpu_torch.tools.probes [--k 1048576]

It prints, per dot variant, one call's median time of 3, its T(fl)op/s
against the published peak of that type, and its checksum (the int8 and
f32 checksums must be equal: 0/1 inputs), then the int16 compare's sum.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import sys

import torch

from ranklib_tpu_torch.utils.errors import RankLibError

# the reference probe's shape: [256, K] x [K, 128], K = 1,048,576
PROBE_M, PROBE_N, PROBE_K = 256, 128, 1 << 20
# one H100 SXM's published dense peaks (NVIDIA data sheet): f32 outside
# the tensor cores, and int8 on the tensor cores
PEAK_OPS = {"f32": 67e12, "int8": 1979e12}

_vp, _i64, _int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def dot_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`dot`: the product in float64, cast to the
    kernel's output type (int32 for int8 inputs, else f32)."""
    out = torch.matmul(a.to(torch.float64), b.to(torch.float64))
    return out.to(torch.int32 if a.dtype == torch.int8 else torch.float32)


def compare_plain(x: torch.Tensor, threshold: int = 3) -> torch.Tensor:
    """Plain version of :func:`compare`."""
    return (x > threshold).to(torch.float32)


@functools.cache
def _kernels() -> ctypes.CDLL:
    from ranklib_tpu_torch.ops import _build

    lib = _build.kernel_library("probes")
    for fn in (lib.probe_dot_i8, lib.probe_dot_f32):
        fn.argtypes = [_vp, _vp, _int, _int, _i64, _vp, _vp]
        fn.restype = _int
    lib.probe_compare_i16.argtypes = [_vp, _i64, _int, _vp, _vp]
    lib.probe_compare_i16.restype = _int
    return lib


def _device(name: str, *ts) -> torch.device:
    dev = ts[0].device
    if dev.type not in ("cpu", "cuda") or any(t.device != dev for t in ts):
        raise RankLibError(f"{name}: all tensors must share one cpu or cuda "
                           f"device")
    if any(not t.is_contiguous() for t in ts):
        raise RankLibError(f"{name}: tensors must be contiguous")
    return dev


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] x b [K, N]``: int8 inputs → int32, f32 inputs → f32.
    On the card the f32 result is exact (and independent of the order of
    the kernel's split-K sums) while every sum is an integer below 2^24,
    as with the probe's 0/1 inputs."""
    name = "dot"
    if a.dtype != b.dtype or a.dtype not in (torch.int8, torch.float32):
        raise RankLibError(f"{name}: inputs must both be int8 or float32, got "
                           f"{a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise RankLibError(f"{name}: shapes {tuple(a.shape)} and "
                           f"{tuple(b.shape)} do not multiply")
    dev = _device(name, a, b)
    if dev.type == "cpu":
        return dot_plain(a, b)
    (M, K), N = a.shape, b.shape[1]
    i8 = a.dtype == torch.int8
    out = torch.zeros((M, N), dtype=torch.int32 if i8 else torch.float32,
                      device=dev)
    if M and N and K:
        lib = _kernels()
        fn = lib.probe_dot_i8 if i8 else lib.probe_dot_f32
        with torch.cuda.device(dev):
            rc = fn(a.data_ptr(), b.data_ptr(), M, N, K, out.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RankLibError(f"{name}: CUDA launch failed with error {rc}")
        dot.launches += 1
    return out


dot.launches = 0


def compare(x: torch.Tensor, threshold: int = 3) -> torch.Tensor:
    """``x > threshold`` over int16 ``x`` as f32 0/1."""
    name = "compare"
    if x.dtype != torch.int16:
        raise RankLibError(f"{name}: x must be int16, got {x.dtype}")
    dev = _device(name, x)
    if dev.type == "cpu":
        return compare_plain(x, threshold)
    out = torch.empty(x.shape, dtype=torch.float32, device=dev)
    if x.numel():
        with torch.cuda.device(dev):
            rc = _kernels().probe_compare_i16(
                x.data_ptr(), x.numel(), int(threshold), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RankLibError(f"{name}: CUDA launch failed with error {rc}")
        compare.launches += 1
    return out


compare.launches = 0


def probe_inputs(k: int, device: torch.device, seed: int = 0):
    """The dot probe's 0/1 int8 operands ``[256, k]`` and ``[k, 128]``,
    drawn on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randint(0, 2, (PROBE_M, k), generator=gen, device=device,
                      dtype=torch.int8)
    b = torch.randint(0, 2, (k, PROBE_N), generator=gen, device=device,
                      dtype=torch.int8)
    return a, b


def compare_input(device: torch.device) -> torch.Tensor:
    """The compare probe's input: ``arange(8·128) % 7`` as int16 [8, 128]."""
    return (torch.arange(8 * 128, device=device) % 7).to(
        torch.int16).reshape(8, 128)


def event_ms(fn, reps: int) -> float:
    """Median device time of one ``fn()`` call over ``reps``, by CUDA
    events, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def measure(k: int = PROBE_K, reps: int = 3, device=None) -> dict:
    """Both dot variants at ``[256, k] x [k, 128]`` and the compare on the
    card: {variant: {ms, tops, peak_share, checksum, plain_equal}} and
    {"compare": {...}}. Raises when a kernel disagrees with its plain
    version or the two checksums differ."""
    dev = torch.device("cuda", 0) if device is None else device
    a8, b8 = probe_inputs(k, dev)
    ops = 2 * PROBE_M * PROBE_N * k
    out = {}
    for variant, (a, b) in (("int8", (a8, b8)),
                            ("f32", (a8.float(), b8.float()))):
        got = dot(a, b)
        want = dot_plain(a, b)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RankLibError(f"dot ({variant}): kernel and plain version "
                               f"differ")
        ms = event_ms(lambda: dot(a, b), reps)
        out[variant] = {"ms": ms, "tops": ops / ms / 1e9,
                        "peak_share": ops / ms / 1e-3 / PEAK_OPS[variant],
                        "checksum": int(got.to(torch.int64).sum())}
    if out["int8"]["checksum"] != out["f32"]["checksum"]:
        raise RankLibError("dot: the int8 and f32 checksums differ")
    x = compare_input(dev)
    got = compare(x)
    torch.cuda.synchronize()
    if not torch.equal(got, compare_plain(x)):
        raise RankLibError("compare: kernel and plain version differ")
    out["compare"] = {"sum": float(got.sum()),
                      "ms": event_ms(lambda: compare(x), reps)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--k", type=int, default=PROBE_K,
                   help="contraction length of the dot probe")
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("probes: CUDA is not available", file=sys.stderr)
        return 2
    res = measure(args.k, args.reps)
    print(f"device: {torch.cuda.get_device_name(0)}")
    for variant in ("f32", "int8"):
        r = res[variant]
        print(f"{variant}: {r['ms']:.4f} ms  {r['tops']:.2f} T(fl)op/s "
              f"({100 * r['peak_share']:.2f}% of the published "
              f"{PEAK_OPS[variant] / 1e12:.0f} T)  checksum {r['checksum']}")
    print(f"int16_compare: result_sum {res['compare']['sum']:.0f} "
          f"({res['compare']['ms']:.4f} ms)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
