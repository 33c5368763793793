"""Best-split scan over node histograms (ranklib_tpu.ops.split_scan).

:func:`best_splits` replaces ``ranklib_tpu/ops/split_scan.py``
``_scan_kernel`` (wrapper ``_scan_rows_pallas``, router ``best_splits``):
for each node of ``hist [Cn, F, B, 2]``, the split (feature, bin) that
maximizes S_L²/c_L + S_R²/c_R over candidates with both sides ≥ mls; the
first max, feature-major, wins ties (ref:
learning/tree/FeatureHistogram.java:~300 findBestSplit). A CPU tensor
takes :func:`best_splits_plain`; on a CUDA tensor one launch of the kernel
in ``csrc/split_scan.cu`` scans every row and finishes each node's first
max, and the wrapper does no torch work after it. The nodes may come as
one tensor or as a pair of tensors (tree growth's two children), so no
copy stacks them. The wrapper counts launches in ``best_splits.launches``.
Nothing falls back.
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


def best_splits_plain(hist, mls: float, fmask=None):
    """The reference's ``best_splits_xla``: cumsum, gain, flat first
    argmax. hist [Cn, F, B, 2] (or a pair of such tensors, nodes in order)
    → (gain [Cn] f32, feature [Cn] int32, bin [Cn] int32, ok [Cn] bool).
    Totals come from each row's own last prefix (every feature bins every
    doc exactly once)."""
    if isinstance(hist, (tuple, list)):
        hist = torch.cat(list(hist))
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
    lib.split_scan.argtypes = [_vp, _vp, _i64, _i64, _int, _int,
                               ctypes.c_float, _vp, _i64, _vp, _vp, _vp, _vp,
                               _vp, _vp, _vp]
    lib.split_scan.restype = _int
    return lib


# per (device, stream): the kernel's node tickets (int32, zero between
# launches: the kernel resets each one it finishes) and row slots (float2)
_workspaces: dict = {}


def _workspace(dev: torch.device, stream: int, Cn: int, rows: int):
    """(tickets, row slots) of at least Cn and ``rows`` entries for launches
    on ``stream``; allocated on first use and grown by doubling, so a
    steady caller allocates nothing. Launches that share a stream run in
    order, so one set serves them all."""
    key = (dev.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws[0].numel() < Cn or ws[1].numel() < 2 * rows:
        old = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel() // 2)
        Cn, rows = max(Cn, 2 * old[0]), max(rows, 2 * old[1])
        ws = (torch.zeros(Cn, dtype=torch.int32, device=dev),
              torch.empty(2 * rows, dtype=torch.float32, device=dev))
        _workspaces[key] = ws
    return ws


def _nodes(hist):
    """(parts, Cn, F, B) of one [Cn, F, B, 2] tensor or a pair of them."""
    parts = tuple(hist) if isinstance(hist, (tuple, list)) else (hist,)
    if not 1 <= len(parts) <= 2:
        raise RankLibError("best_splits: hist must be one tensor or a pair")
    shape = None
    for h in parts:
        if not isinstance(h, torch.Tensor) or h.dim() != 4 \
                or h.shape[-1] != 2 or h.shape[2] < 1:
            raise RankLibError(f"best_splits: hist must be [Cn, F, B, 2], "
                               f"got {tuple(getattr(h, 'shape', ()))}")
        if h.dtype != torch.float32:
            raise RankLibError(f"best_splits: hist must be float32, got "
                               f"{h.dtype}")
        if shape is not None and (h.shape[1:] != shape
                                  or h.device != parts[0].device):
            raise RankLibError("best_splits: the pair must share F, B and "
                               "the device")
        shape = h.shape[1:]
    F, B = int(shape[0]), int(shape[1])
    return parts, sum(int(h.shape[0]) for h in parts), F, B


def launch_args(hist, mls: float, fmask=None):
    """(arguments of ``split_scan``, (gain, feature, bin, ok)): one launch
    over CUDA ``hist`` (a contiguous [Cn, F, B, 2] f32 tensor or a pair of
    them, Cn and F > 0) with its outputs allocated — what
    :func:`best_splits` launches, for timing the launch alone."""
    return _launch_args(*_nodes(hist), mls, fmask)


def _stream_handle(dev: torch.device) -> int:
    """The current CUDA stream of ``dev`` as an integer handle, without
    building a ``torch.cuda.Stream`` (a few µs a call on the host)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_args(parts, Cn: int, F: int, B: int, mls: float, fmask):
    dev = parts[0].device
    if any(not h.is_contiguous() for h in parts):
        raise RankLibError("best_splits: hist must be contiguous")
    mask, mstride = None, 0
    if fmask is not None:
        if fmask.dtype != torch.bool or fmask.shape != (Cn, F) \
                or fmask.device != dev or (F > 1 and fmask.stride(1) != 1):
            raise RankLibError(f"best_splits: fmask must be a [{Cn}, {F}] "
                               f"bool tensor on {dev} with unit feature "
                               f"stride")
        mask, mstride = fmask.data_ptr(), fmask.stride(0)
    stream = _stream_handle(dev)
    tickets, rows = _workspace(dev, stream, Cn, Cn * F)
    # one allocation: gain bits, feature, bin, then ok's bytes
    g, f, b, okw = torch.empty((4, Cn), dtype=torch.int32,
                               device=dev).unbind(0)
    ok = okw.view(torch.bool)[:Cn]
    base0 = parts[0].data_ptr()
    args = (base0, parts[-1].data_ptr() if len(parts) == 2 else base0,
            int(parts[0].shape[0]) if len(parts) == 2 else Cn, Cn, F, B,
            _floor_mls(mls), mask, mstride, rows.data_ptr(),
            tickets.data_ptr(), g.data_ptr(), f.data_ptr(), b.data_ptr(),
            ok.data_ptr(), stream)
    return args, (g.view(torch.float32), f, b, ok)


def best_splits(hist, mls: float, fmask=None):
    """Routed best-split scan; ``hist`` [Cn, F, B, 2] f32 (contiguous on
    CUDA), or a pair of such tensors whose nodes follow in order (the two
    children of a growth step, unstacked). ``fmask`` optional [Cn, F]
    bool (on CUDA with unit feature stride; an expanded row is fine).
    Returns (gain [Cn] f32, feature [Cn] int32, bin [Cn] int32, ok [Cn]
    bool)."""
    parts, Cn, F, B = _nodes(hist)
    dev = parts[0].device
    if dev.type == "cpu":
        return best_splits_plain(parts[0] if len(parts) == 1 else parts,
                                 mls, fmask)
    if dev.type != "cuda":
        raise RankLibError(f"best_splits: tensors on {dev} are not "
                           f"supported")
    if Cn == 0 or F == 0:
        # no rows to scan: nothing valid, the flat argmax's (0, 0)
        z = torch.zeros(Cn, dtype=torch.int32, device=dev)
        return (torch.full((Cn,), -torch.inf, device=dev), z, z.clone(),
                torch.zeros(Cn, dtype=torch.bool, device=dev))
    args, out = _launch_args(parts, Cn, F, B, mls, fmask)
    if dev.index == torch.cuda.current_device():
        rc = _kernels().split_scan(*args)
    else:
        with torch.cuda.device(dev):
            rc = _kernels().split_scan(*args)
    if rc != 0:
        raise RankLibError(f"best_splits: CUDA launch failed with error "
                           f"{rc}")
    best_splits.launches += 1
    return out


best_splits.launches = 0
