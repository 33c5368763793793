"""Masked (Σw·g, Σw) feature histograms: tree growth's hot loop.

* :func:`histogram` replaces ``ranklib_tpu/ops/histogram.py``
  ``_hist_radix_kernel`` (wrapper ``hist_pallas_radix``, router
  ``_hist_auto``): one weight vector, kernel ``csrc/histogram.cu``.
* :func:`histogram_multi` replaces ``_hist_kernel`` (wrappers
  ``_hist_pallas_rows``, ``hist_multi_pallas``): C bags of Random Forests
  over one id matrix in one launch, kernel ``csrc/histogram_multi.cu``.

A CPU tensor takes the plain version (:func:`histogram_plain`,
:func:`histogram_multi_plain`), a CUDA tensor the kernel (see each .cu
header for the design and its determinism). The TPU routed only B = 256
to its kernels, a width gate of its compiler; the port takes any B on both
routes.

The wrappers launch on the current stream, allocate their outputs and
scratch with ``torch.empty``, raise on a failed launch and count launches
in ``histogram.launches`` / ``histogram_multi.launches``. Nothing falls
back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ranklib_tpu_torch.utils.errors import RankLibError

# docs per block of the CUDA kernel, and the shared-memory budget of the
# per-feature histograms a block keeps (the kernel adds 8 B per doc of
# staging)
HIST_CHUNK = 4096
_HIST_SMEM = 64 * 1024
_MAX_SMEM = 232448                   # what one H100 block can use
_MAX_FEATS_PER_BLOCK = 32            # four features for each of 8 warps
# the multi-bag kernel: docs staged per step, the shared-memory budget of a
# block (its [feats, bags, B, 2] histograms and [bags, sub] staged g·w and
# w; two blocks fit an SM), one feature per warp, and the blocks that fill
# the card twice over
HIST_MULTI_SUB = 512
_MULTI_SMEM = 80 * 1024
_MULTI_FEATS = 8
_MULTI_TARGET_BLOCKS = 4 * 132


def histogram_plain(binned_T: torch.Tensor, grad: torch.Tensor,
                    mask: torch.Tensor, n_bins: int) -> torch.Tensor:
    """The reference's ``hist_xla`` as one flat ``index_add_``:
    ``binned_T [F, N]`` integer ids (upcast to int64 first: a uint8
    compare against 256 wraps), ``grad [N]`` f32, ``mask [N]`` bool or f32
    weights → ``[F, B, 2]`` f32 (Σw·g, Σw). Ids ≥ B add nothing."""
    F, N = binned_T.shape
    B = int(n_bins)
    binned = binned_T.to(torch.int64)
    m = mask.to(torch.float32)
    ids = (torch.arange(F, device=binned.device)[:, None] * B
           + torch.clamp(binned, max=B - 1)).reshape(-1)
    keep = (binned < B).reshape(-1)
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
        fn.argtypes = [_vp, _vp, _vp, _i64, _int, _int, _int, _int, _vp,
                       _vp, _vp, _vp]
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


def feats_per_block(F: int, B: int) -> int:
    """Features one CUDA block histograms: as many [B, 2] f32 histograms
    as fit the budget, at most four per warp; at least one."""
    return max(1, min(F, _MAX_FEATS_PER_BLOCK, _HIST_SMEM // (B * 8)))


def histogram(binned_T: torch.Tensor, grad: torch.Tensor, mask: torch.Tensor,
              n_bins: int) -> torch.Tensor:
    """``[F, B, 2]`` f32 (Σw·g, Σw) histogram of ``binned_T [F, N]``
    (contiguous uint8/int16/int32 ids) under ``grad [N]`` f32 and ``mask
    [N]`` bool or f32 weights; ids ≥ B add nothing."""
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
    feats = feats_per_block(F, B)
    smem = (2 * HIST_CHUNK + feats * B * 2) * 4
    if smem > _MAX_SMEM:
        raise RankLibError(f"{name}: {B} bins need {smem} bytes of shared "
                           f"memory a block, over the card's {_MAX_SMEM}")
    out = torch.empty((F, B, 2), dtype=torch.float32, device=dev)
    if N == 0 or F == 0:
        return out.zero_()
    n_chunks = (N + HIST_CHUNK - 1) // HIST_CHUNK
    partial = torch.empty(n_chunks * F * B * 2, dtype=torch.float32,
                          device=dev)
    nonempty = torch.empty(n_chunks, dtype=torch.int32, device=dev)
    w = mask.to(torch.float32).contiguous()
    g = grad.contiguous()
    fn = getattr(_kernels(), f"histogram_{_TYPES[binned_T.dtype]}")
    with torch.cuda.device(dev):
        rc = fn(binned_T.data_ptr(), g.data_ptr(), w.data_ptr(), N, F, B,
                HIST_CHUNK, feats, partial.data_ptr(), nonempty.data_ptr(),
                out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RankLibError(f"{name}: CUDA launch failed with error {rc}")
    histogram.launches += 1
    return out


histogram.launches = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def multi_tiles(F: int, B: int, C: int) -> tuple:
    """(features, bags) one block of the multi-bag kernel histograms: at
    most one feature per warp, and as many bags as the block's budget
    holds (per bag: [feats, B, 2] f32 histograms and [sub] staged g·w and
    w); at least one of each."""
    stage = 8 * HIST_MULTI_SUB
    feats = max(1, min(F, _MULTI_FEATS, (_MULTI_SMEM - stage) // (B * 8)))
    return feats, max(1, min(C, _MULTI_SMEM // (stage + feats * B * 8)))


def histogram_multi(binned_T: torch.Tensor, grads: torch.Tensor,
                    weights: torch.Tensor, n_bins: int) -> torch.Tensor:
    """``[C, F, B, 2]`` f32 (Σw_c·g_c, Σw_c) histograms of C bags over one
    id matrix ``binned_T [F, N]`` (contiguous uint8/int16/int32):
    ``grads [C, N]`` f32 pseudo-responses, ``weights [C, N]`` bool or f32
    doc weights (integer multiplicities ≥ 0). Ids ≥ B add nothing. One
    launch serves every bag."""
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
    feats, bags = multi_tiles(F, B, C)
    smem = (2 * bags * HIST_MULTI_SUB + feats * bags * B * 2) * 4
    if smem > _MAX_SMEM:
        raise RankLibError(f"{name}: {B} bins need {smem} bytes of shared "
                           f"memory a block, over the card's {_MAX_SMEM}")
    out = torch.empty((C, F, B, 2), dtype=torch.float32, device=dev)
    if N == 0 or F == 0 or C == 0:
        return out.zero_()
    # document slices: enough blocks to fill the card, none under 2,048
    # docs, each a whole number of 32-doc steps
    blocks = _cdiv(F, feats) * _cdiv(C, bags)
    n_slices = max(1, min(_cdiv(_MULTI_TARGET_BLOCKS, blocks), _cdiv(N, 2048)))
    slice_len = _cdiv(_cdiv(N, n_slices), 32) * 32
    n_slices = _cdiv(N, slice_len)
    partial = (torch.empty(n_slices * C * F * B * 2, dtype=torch.float32,
                           device=dev) if n_slices > 1 else out)
    w = weights.to(torch.float32).contiguous()
    g = grads.contiguous()
    fn = getattr(_multi_kernels(),
                 f"histogram_multi_{_TYPES[binned_T.dtype]}")
    with torch.cuda.device(dev):
        rc = fn(binned_T.data_ptr(), g.data_ptr(), w.data_ptr(), N, F, B, C,
                feats, bags, slice_len, n_slices, HIST_MULTI_SUB,
                partial.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RankLibError(f"{name}: CUDA launch failed with error {rc}")
    histogram_multi.launches += 1
    return out


histogram_multi.launches = 0
