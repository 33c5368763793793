"""Masked (Σw·g, Σw) feature histograms: tree growth's hot loop.

* :func:`histogram` replaces ``ranklib_tpu/ops/histogram.py``
  ``_hist_radix_kernel`` (wrapper ``hist_pallas_radix``, router
  ``_hist_auto``): one weight vector, kernel ``csrc/histogram.cu``.
* :func:`histogram_multi` replaces ``_hist_kernel`` (wrappers
  ``_hist_pallas_rows``, ``hist_multi_pallas``): C bags of Random Forests
  over one id matrix in one launch, kernel ``csrc/histogram_multi.cu``.

A CPU tensor takes the plain version (:func:`histogram_plain`,
:func:`histogram_multi_plain`), a CUDA tensor the kernel. Both kernels are
one design, lane-owned histogram columns (``csrc/histogram_common.cuh``
describes it, its determinism and what bounds it); :func:`plan` lays out
either launch. The TPU routed only B = 256 to its kernels, a width gate of
its compiler; the port takes any B on both routes.

The wrappers launch on the current stream, allocate their outputs and
scratch with ``torch.empty``, raise on a failed launch and count launches
in ``histogram.launches`` / ``histogram_multi.launches``. Nothing falls
back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ranklib_tpu_torch.utils.errors import RankLibError

# what one H100 offers a block and an SM (bytes of shared memory, the
# SM's less the 1 KB it keeps for each resident block), its SMs, and the
# kernel's fixed shapes (csrc/histogram_common.cuh: one 32-lane warp a
# block, at most 256 bins a warp, steps of 128 id bytes a lane, so slices
# are whole multiples of 128 documents, and a [32][33] float2 write-out
# tile that the lanes' id rows share)
_MAX_SMEM = 232448
_SM_SMEM = 233472
_BLOCK_RESERVED = 1024
_SMS = 132
_MAX_BLOCKS_PER_SM = 32
_LANES = 32
_WARP_BINS = 256
_TPOSE_BYTES = _LANES * (_LANES + 1) * 8
_STEP_DOCS = 128
# the least documents a slice takes, so slice partials stay a small part
# of the traffic
_MIN_SLICE = 2048


def histogram_plain(binned_T: torch.Tensor, grad: torch.Tensor,
                    mask: torch.Tensor, n_bins: int) -> torch.Tensor:
    """The reference's ``hist_xla`` as one flat ``index_add_``:
    ``binned_T [F, N]`` integer ids (upcast to int64 first: a uint8
    compare against 256 wraps), ``grad [N]`` f32, ``mask [N]`` bool or f32
    weights → ``[F, B, 2]`` f32 (Σw·g, Σw). Ids < 0 or ≥ B add nothing, as
    in the kernels and the reference's radix kernel; the index is clamped
    at both ends, so a dropped id never lands in a neighbouring feature."""
    F, N = binned_T.shape
    B = int(n_bins)
    binned = binned_T.to(torch.int64)
    m = mask.to(torch.float32)
    ids = (torch.arange(F, device=binned.device)[:, None] * B
           + torch.clamp(binned, min=0, max=B - 1)).reshape(-1)
    keep = ((binned >= 0) & (binned < B)).reshape(-1)
    data = torch.stack([(grad * m).expand(F, N).reshape(-1),
                        m.expand(F, N).reshape(-1)], dim=-1)
    data = torch.where(keep[:, None], data, 0.0)
    out = torch.zeros((F * B, 2), dtype=torch.float32, device=binned.device)
    return out.index_add_(0, ids, data).view(F, B, 2)


def histogram_multi_plain(binned_T: torch.Tensor, grads: torch.Tensor,
                          weights: torch.Tensor, n_bins: int) -> torch.Tensor:
    """The reference's ``hist_multi_xla``: :func:`histogram_plain` per bag,
    stacked. ``grads``/``weights`` [C, N] → [C, F, B, 2] f32."""
    F, _ = binned_T.shape
    if grads.shape[0] == 0:
        return torch.zeros((0, F, int(n_bins), 2), dtype=torch.float32,
                           device=binned_T.device)
    return torch.stack([histogram_plain(binned_T, g, w, n_bins)
                        for g, w in zip(grads, weights)])


_vp, _i64, _int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_TYPES = {torch.uint8: "u8", torch.int16: "i16", torch.int32: "i32"}


@functools.cache
def _kernels() -> ctypes.CDLL:
    from ranklib_tpu_torch.ops import _build

    lib = _build.kernel_library("histogram")
    for t in _TYPES.values():
        fn = getattr(lib, f"histogram_{t}")
        fn.argtypes = [_vp, _vp, _vp, _i64, _int, _int, _int, _int, _i64,
                       _int, _int, _vp, _vp, _vp]
        fn.restype = _int
    return lib


@functools.cache
def _multi_kernels() -> ctypes.CDLL:
    from ranklib_tpu_torch.ops import _build

    lib = _build.kernel_library("histogram_multi")
    for t in _TYPES.values():
        fn = getattr(lib, f"histogram_multi_{t}")
        fn.argtypes = [_vp, _vp, _vp, _i64, _int, _int, _int, _int, _int,
                       _i64, _int, _int, _vp, _vp, _vp]
        fn.restype = _int
    return lib


def _check_ids(name: str, binned_T: torch.Tensor) -> None:
    if binned_T.dtype not in _TYPES:
        raise RankLibError(f"{name}: ids must be uint8, int16 or int32, "
                           f"got {binned_T.dtype}")
    if binned_T.dim() != 2 or not binned_T.is_contiguous():
        raise RankLibError(f"{name}: ids must be a contiguous [F, N] "
                           f"matrix, got {tuple(binned_T.shape)}")


def _check_devices(name: str, *tensors) -> torch.device:
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda") or any(t.device != dev
                                              for t in tensors):
        raise RankLibError(f"{name}: all tensors must share one cpu or "
                           f"cuda device")
    return dev


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class HistPlan(NamedTuple):
    """One launch of the lane-owned column kernel: a block is one warp
    owning 32 features of one bag over ``warp_bins`` bins, one of
    ``ranges`` bin ranges and one of ``slices`` document slices of
    ``slice_len`` documents; ``grid`` is (slices, feature groups x ranges,
    bags) and ``smem`` the block's shared-memory bytes."""

    warp_bins: int
    ranges: int
    slice_len: int
    slices: int
    grid: tuple
    smem: int


@functools.lru_cache(maxsize=256)
def plan(F: int, B: int, C: int, N: int) -> HistPlan:
    """Lay out a histogram launch of ``C`` bags (1 for :func:`histogram`)
    over ``[F, N]`` ids and ``B`` bins.

    A warp covers min(B, 256) bins (more bins take more ranges, so any B
    fits). Document slices are added until the warps fill every SM once,
    none under ``_MIN_SLICE`` documents and each a whole number of
    128-document steps. Shared memory (csrc/histogram_common.cuh
    ``smem_bytes``): the warp's [bins][32] float2 histograms, then the
    write-out tile (the lanes' id rows fit in it)."""
    warp_bins = max(1, min(B, _WARP_BINS))
    ranges = _cdiv(max(B, 1), warp_bins)
    smem = warp_bins * _LANES * 8 + _TPOSE_BYTES
    blocks = _cdiv(max(F, 1), _LANES) * ranges * max(C, 1)
    per_sm = max(1, min(_MAX_BLOCKS_PER_SM,
                        _SM_SMEM // (smem + _BLOCK_RESERVED)))
    slices = max(1, min(_cdiv(_SMS * per_sm, blocks), _cdiv(N, _MIN_SLICE)))
    slice_len = _cdiv(_cdiv(max(N, 1), slices), _STEP_DOCS) * _STEP_DOCS
    slices = _cdiv(max(N, 1), slice_len)
    return HistPlan(warp_bins, ranges, slice_len, slices,
                    (slices, blocks // max(C, 1), max(C, 1)), smem)


def _launch(fn, name: str, binned_T, grads, w, C: int, B: int,
            out: torch.Tensor, multi: bool) -> None:
    """One launch of ``fn`` on the current stream of ``out``'s device."""
    F, N = binned_T.shape
    p = plan(F, B, C, N)
    dev = out.device
    partial = (torch.empty(p.slices * out.numel(), dtype=torch.float32,
                           device=dev) if p.slices > 1 else out)
    ids = binned_T.data_ptr()
    # id rows 16-byte aligned: 16-byte loads (else one id a load)
    vec = int(ids % 16 == 0 and N * binned_T.element_size() % 16 == 0)
    shape = (F, B, C) if multi else (F, B)
    args = (ids, grads.data_ptr(), w.data_ptr(), N, *shape, p.warp_bins,
            p.ranges, p.slice_len, p.slices, vec, partial.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args)
    if rc != 0:
        raise RankLibError(f"{name}: CUDA launch failed with error {rc}")


def histogram(binned_T: torch.Tensor, grad: torch.Tensor, mask: torch.Tensor,
              n_bins: int) -> torch.Tensor:
    """``[F, B, 2]`` f32 (Σw·g, Σw) histogram of ``binned_T [F, N]``
    (contiguous uint8/int16/int32 ids) under ``grad [N]`` f32 and ``mask
    [N]`` bool or f32 weights; ids < 0 or ≥ B add nothing."""
    name = "histogram"
    _check_ids(name, binned_T)
    F, N = binned_T.shape
    if grad.shape != (N,) or mask.shape != (N,):
        raise RankLibError(f"{name}: grad and mask must be [{N}], got "
                           f"{tuple(grad.shape)} and {tuple(mask.shape)}")
    if grad.dtype != torch.float32 or mask.dtype not in (torch.bool,
                                                         torch.float32):
        raise RankLibError(f"{name}: grad must be float32 and mask bool or "
                           f"float32, got {grad.dtype} and {mask.dtype}")
    dev = _check_devices(name, binned_T, grad, mask)
    B = int(n_bins)
    if dev.type == "cpu":
        return histogram_plain(binned_T, grad, mask, B)
    out = torch.empty((F, B, 2), dtype=torch.float32, device=dev)
    if N == 0 or F == 0 or B == 0:
        return out.zero_()
    w = mask if mask.dtype == torch.float32 else mask.to(torch.float32)
    _launch(getattr(_kernels(), f"histogram_{_TYPES[binned_T.dtype]}"),
            name, binned_T, grad.contiguous(), w.contiguous(), 1, B, out,
            multi=False)
    histogram.launches += 1
    return out


histogram.launches = 0


def histogram_multi(binned_T: torch.Tensor, grads: torch.Tensor,
                    weights: torch.Tensor, n_bins: int) -> torch.Tensor:
    """``[C, F, B, 2]`` f32 (Σw_c·g_c, Σw_c) histograms of C bags over one
    id matrix ``binned_T [F, N]`` (contiguous uint8/int16/int32):
    ``grads [C, N]`` f32 pseudo-responses, ``weights [C, N]`` bool or f32
    doc weights (integer multiplicities ≥ 0). Ids < 0 or ≥ B add nothing.
    One launch serves every bag."""
    name = "histogram_multi"
    _check_ids(name, binned_T)
    F, N = binned_T.shape
    if grads.dim() != 2 or grads.shape[1] != N \
            or weights.shape != grads.shape:
        raise RankLibError(f"{name}: grads and weights must be [C, {N}], "
                           f"got {tuple(grads.shape)} and "
                           f"{tuple(weights.shape)}")
    if grads.dtype != torch.float32 or weights.dtype not in (torch.bool,
                                                             torch.float32):
        raise RankLibError(f"{name}: grads must be float32 and weights bool "
                           f"or float32, got {grads.dtype} and "
                           f"{weights.dtype}")
    dev = _check_devices(name, binned_T, grads, weights)
    B = int(n_bins)
    if dev.type == "cpu":
        return histogram_multi_plain(binned_T, grads, weights, B)
    C = grads.shape[0]
    out = torch.empty((C, F, B, 2), dtype=torch.float32, device=dev)
    if N == 0 or F == 0 or C == 0 or B == 0:
        return out.zero_()
    w = (weights if weights.dtype == torch.float32
         else weights.to(torch.float32))
    _launch(getattr(_multi_kernels(),
                    f"histogram_multi_{_TYPES[binned_T.dtype]}"),
            name, binned_T, grads.contiguous(), w.contiguous(), C, B, out,
            multi=True)
    histogram_multi.launches += 1
    return out


histogram_multi.launches = 0
