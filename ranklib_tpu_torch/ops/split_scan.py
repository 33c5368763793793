"""Best-split scan over node histograms (ranklib_tpu.ops.split_scan).

:func:`best_splits` replaces ``ranklib_tpu/ops/split_scan.py``
``_scan_kernel`` (wrapper ``_scan_rows_pallas``, router ``best_splits``):
for each node of ``hist [Cn, F, B, 2]``, the split (feature, bin) that
maximizes S_L²/c_L + S_R²/c_R over candidates with both sides ≥ mls; the
first max, feature-major, wins ties (ref:
learning/tree/FeatureHistogram.java:~300 findBestSplit). A CPU tensor
takes :func:`best_splits_plain`; on a CUDA tensor the per-row scan is the
kernel in ``csrc/split_scan.cu`` and the cross-feature first max over
``[Cn, F]`` stays in torch. The wrapper counts launches in
``best_splits.launches``. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ranklib_tpu_torch.utils.errors import RankLibError


def _floor_mls(mls: float) -> float:
    # -mls 0 must still reject EMPTY sides: a 0-count side scores
    # s²/max(c, 1) = the parent term and could tie-win the first max,
    # where the reference's 0/0 = NaN never wins
    return max(float(mls), 1e-9)


def best_splits_plain(hist: torch.Tensor, mls: float, fmask=None):
    """The reference's ``best_splits_xla``: cumsum, gain, flat first
    argmax. hist [Cn, F, B, 2] → (gain [Cn] f32, feature [Cn] int32,
    bin [Cn] int32, ok [Cn] bool). Totals come from each row's own last
    prefix (every feature bins every doc exactly once)."""
    mls = _floor_mls(mls)
    c_l = torch.cumsum(hist[..., 1], dim=2)
    s_l = torch.cumsum(hist[..., 0], dim=2)
    c_r = c_l[..., -1:] - c_l
    s_r = s_l[..., -1:] - s_l
    ok = (c_l >= mls) & (c_r >= mls)
    if fmask is not None:
        ok = ok & fmask[:, :, None]
    gain = torch.where(
        ok,
        s_l * s_l / torch.clamp(c_l, min=1.0)
        + s_r * s_r / torch.clamp(c_r, min=1.0),
        -torch.inf)
    Cn, F, B = gain.shape
    flat = gain.reshape(Cn, F * B)
    idx = torch.argmax(flat, dim=1)
    g = torch.gather(flat, 1, idx[:, None])[:, 0]
    return (g, (idx // B).to(torch.int32), (idx % B).to(torch.int32),
            torch.isfinite(g))


_vp, _i64, _int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


@functools.cache
def _kernels() -> ctypes.CDLL:
    from ranklib_tpu_torch.ops import _build

    lib = _build.kernel_library("split_scan")
    lib.split_scan.argtypes = [_vp, _i64, _int, ctypes.c_float, _vp, _vp,
                               _vp]
    lib.split_scan.restype = _int
    return lib


def best_splits(hist: torch.Tensor, mls: float, fmask=None):
    """Routed best-split scan; hist [Cn, F, B, 2] f32 (contiguous on
    CUDA), fmask optional [Cn, F] bool. Returns (gain [Cn] f32,
    feature [Cn] int32, bin [Cn] int32, ok [Cn] bool)."""
    if hist.dim() != 4 or hist.shape[-1] != 2 or hist.shape[2] < 1:
        raise RankLibError(f"best_splits: hist must be [Cn, F, B, 2], got "
                           f"{tuple(hist.shape)}")
    if hist.dtype != torch.float32:
        raise RankLibError(f"best_splits: hist must be float32, got "
                           f"{hist.dtype}")
    if hist.device.type == "cpu":
        return best_splits_plain(hist, mls, fmask)
    if hist.device.type != "cuda":
        raise RankLibError(f"best_splits: tensors on {hist.device} are not "
                           f"supported")
    if not hist.is_contiguous():
        raise RankLibError("best_splits: hist must be contiguous")
    Cn, F, B, _ = hist.shape
    # per row (node, feature): the max gain and its first bin
    g = torch.empty((Cn, F), dtype=torch.float32, device=hist.device)
    b = torch.empty((Cn, F), dtype=torch.int32, device=hist.device)
    if Cn * F:
        with torch.cuda.device(hist.device):
            rc = _kernels().split_scan(
                hist.data_ptr(), Cn * F, B, _floor_mls(mls), g.data_ptr(),
                b.data_ptr(), torch.cuda.current_stream(hist.device)
                .cuda_stream)
        if rc != 0:
            raise RankLibError(f"best_splits: CUDA launch failed with "
                               f"error {rc}")
        best_splits.launches += 1
    if fmask is not None:
        g = torch.where(fmask, g, -torch.inf)
    # first max feature-major: with the kernel's first-max bin this is the
    # flat (f, b) argmax's tie order
    f_best = torch.argmax(g, dim=1)
    g_best = torch.gather(g, 1, f_best[:, None])[:, 0]
    ok = torch.isfinite(g_best)
    # nothing valid: (0, 0), the flat argmax's answer (a masked-out row's
    # own best bin would otherwise leak through)
    b_best = torch.where(ok, torch.gather(b, 1, f_best[:, None])[:, 0], 0)
    return g_best, f_best.to(torch.int32), b_best, ok


best_splits.launches = 0
