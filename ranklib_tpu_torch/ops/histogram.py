"""Masked (Σw·g, Σw) feature histograms: tree growth's hot loop.

:func:`histogram` replaces ``ranklib_tpu/ops/histogram.py``
``_hist_radix_kernel`` (wrapper ``hist_pallas_radix``, router
``_hist_auto``): a CPU tensor takes :func:`histogram_plain`, a CUDA tensor
the kernel in ``csrc/histogram.cu`` (see its header for the design and
its determinism). The TPU routed only B = 256 to its kernel, a width gate
of its compiler; the port takes any B on both routes.

The wrapper launches on the current stream, allocates its output and
scratch with ``torch.empty``, raises on a failed launch and counts
launches in ``histogram.launches``. Nothing falls back.
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


_vp, _i64, _int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_FN = {torch.uint8: "histogram_u8", torch.int16: "histogram_i16",
       torch.int32: "histogram_i32"}


@functools.cache
def _kernels() -> ctypes.CDLL:
    from ranklib_tpu_torch.ops import _build

    lib = _build.kernel_library("histogram")
    for name in _FN.values():
        fn = getattr(lib, name)
        fn.argtypes = [_vp, _vp, _vp, _i64, _int, _int, _int, _int, _vp,
                       _vp, _vp, _vp]
        fn.restype = _int
    return lib


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
    if binned_T.dtype not in _FN:
        raise RankLibError(f"{name}: ids must be uint8, int16 or int32, "
                           f"got {binned_T.dtype}")
    if binned_T.dim() != 2 or not binned_T.is_contiguous():
        raise RankLibError(f"{name}: ids must be a contiguous [F, N] "
                           f"matrix, got {tuple(binned_T.shape)}")
    F, N = binned_T.shape
    if grad.shape != (N,) or mask.shape != (N,):
        raise RankLibError(f"{name}: grad and mask must be [{N}], got "
                           f"{tuple(grad.shape)} and {tuple(mask.shape)}")
    if grad.dtype != torch.float32 or mask.dtype not in (torch.bool,
                                                         torch.float32):
        raise RankLibError(f"{name}: grad must be float32 and mask bool or "
                           f"float32, got {grad.dtype} and {mask.dtype}")
    dev = binned_T.device
    if dev.type not in ("cpu", "cuda") or grad.device != dev \
            or mask.device != dev:
        raise RankLibError(f"{name}: ids, grad and mask must share one cpu "
                           f"or cuda device")
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
    fn = getattr(_kernels(), _FN[binned_T.dtype])
    with torch.cuda.device(dev):
        rc = fn(binned_T.data_ptr(), g.data_ptr(), w.data_ptr(), N, F, B,
                HIST_CHUNK, feats, partial.data_ptr(), nonempty.data_ptr(),
                out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RankLibError(f"{name}: CUDA launch failed with error {rc}")
    histogram.launches += 1
    return out


histogram.launches = 0
