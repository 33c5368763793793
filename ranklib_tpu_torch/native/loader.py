"""ctypes bridge to the reference's native LETOR parser and feature binner.

The C++ lives in the reference package (``ranklib_tpu/native/
letor_parser.cpp`` and ``binner.cpp``, which share ``common.h``). This
module compiles those files BY PATH with ``g++`` into the port's own build
directory (``ops._build``) — it copies no C++, builds nothing next to the
reference and imports no Python from it. When the sources or a compiler
are missing every entry point returns ``None`` and the callers run their
Python/numpy fallbacks, exactly as the reference's loader does.

Ported entry points: :func:`native_parse_letor` (dense parse) and
:func:`native_bin_features_transposed` (serving-upload binning).
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from ranklib_tpu_torch.utils.errors import RankLibError

_REF_NATIVE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "ranklib_tpu", "native")
_COMMON_H = os.path.join(_REF_NATIVE, "common.h")

QID_STRIDE = 64
DESC_STRIDE = 160

_i64 = ctypes.c_int64
_vp = ctypes.c_void_p


class NativeParseError(Exception):
    pass


def _compile(name: str, extra_flags=()):
    from ranklib_tpu_torch.ops._build import compile_shared

    src = os.path.join(_REF_NATIVE, f"{name}.cpp")
    if not os.path.exists(src):
        return None
    try:
        path = compile_shared(
            name, ("g++", "-O3", "-shared", "-fPIC", *extra_flags), (src,),
            (_COMMON_H,), timeout=120.0)
        return ctypes.CDLL(path)
    except (RankLibError, OSError):
        return None


@functools.cache
def _parser_lib():
    lib = _compile("letor_parser")
    if lib is None:
        return None
    lib.letor_stat.argtypes = [ctypes.c_char_p, _vp, _vp, _vp]
    lib.letor_stat.restype = ctypes.c_int
    lib.letor_fill.argtypes = [
        ctypes.c_char_p, _vp, _vp, _i64, _i64, _vp, _i64,
        ctypes.c_char_p, _i64, ctypes.c_char_p, _i64, _vp,
    ]
    lib.letor_fill.restype = ctypes.c_int
    return lib


@functools.cache
def _binner_lib():
    lib = _compile("binner", ("-pthread",))
    if lib is None:
        return None
    for fn in (lib.bin_features_u8_T, lib.bin_features_i16_T):
        fn.argtypes = [_vp, _vp, _vp, _i64, _i64, _i64, _i64, _i64]
        fn.restype = ctypes.c_int
    return lib


def native_parse_letor(path: str):
    """Parse a plain (non-gzip) LETOR file natively.

    Returns (labels[N] f32, feats[N, F] f32, qptr[Q+1] i64, qids list[str],
    descs list[str], counts[N] i32, max_fid int) — F = max_fid, ``counts``
    is the per-line number of fid:val pairs, for the strict
    missing-feature check — or None when the
    native path is unavailable (no compiler, gzip input). Raises
    NativeParseError on malformed input so the caller can re-parse in
    Python for a precise error message.
    """
    if path.endswith(".gz"):
        return None
    lib = _parser_lib()
    if lib is None:
        return None
    n_docs, n_queries, max_fid = _i64(0), _i64(0), _i64(0)
    rc = lib.letor_stat(path.encode(), ctypes.addressof(n_docs),
                        ctypes.addressof(n_queries),
                        ctypes.addressof(max_fid))
    if rc == -1:
        return None                       # io error → let Python report it
    if rc == -4:
        raise NativeParseError(f"oversized token in {path}")
    if rc != 0:
        raise NativeParseError(f"malformed LETOR file: {path}")
    N, Q, F = n_docs.value, n_queries.value, max_fid.value
    if N == 0 or Q == 0:
        raise NativeParseError(f"no data lines in {path}")

    labels = np.zeros(N, np.float32)
    feats = np.zeros((N, F), np.float32)
    qptr = np.zeros(Q + 1, np.int64)
    counts = np.zeros(N, np.int32)
    qidbuf = ctypes.create_string_buffer(Q * QID_STRIDE)
    descbuf = ctypes.create_string_buffer(N * DESC_STRIDE)
    rc = lib.letor_fill(path.encode(), labels.ctypes.data, feats.ctypes.data,
                        N, F, qptr.ctypes.data, Q, qidbuf, QID_STRIDE,
                        descbuf, DESC_STRIDE, counts.ctypes.data)
    if rc != 0:
        raise NativeParseError(f"native parse failed (rc={rc}): {path}")

    qraw = qidbuf.raw                 # .raw copies the buffer — take it ONCE
    qids = [qraw[i * QID_STRIDE:(i + 1) * QID_STRIDE]
            .split(b"\0", 1)[0].decode() for i in range(Q)]
    draw = descbuf.raw
    descs = [draw[i * DESC_STRIDE:(i + 1) * DESC_STRIDE]
             .split(b"\0", 1)[0].decode(errors="replace") for i in range(N)]
    return labels, feats, qptr, qids, descs, counts, F


def native_bin_features_transposed(feats: np.ndarray, thresholds: np.ndarray,
                                   clamp: int, dtype):
    """Serving-upload binning: ``searchsorted(thresholds[f], x, 'left')``
    clamped to ``clamp`` (NaN included), narrowed to ``dtype`` (uint8 or
    int16) and transposed, in one multithreaded C++ pass. Returns [F, N]
    contiguous ``dtype``, or None when unavailable (caller runs numpy)."""
    lib = _binner_lib()
    dtype = np.dtype(dtype)
    if lib is None or dtype not in (np.uint8, np.int16):
        return None
    fn, lim = ((lib.bin_features_u8_T, 255) if dtype == np.uint8
               else (lib.bin_features_i16_T, 32767))
    if not 0 <= clamp <= lim:
        return None
    feats = np.ascontiguousarray(feats, dtype=np.float32)
    thr = np.ascontiguousarray(thresholds, dtype=np.float32)
    N, F = feats.shape
    if thr.shape[0] != F:
        return None
    out = np.empty((F, N), dtype)
    rc = fn(feats.ctypes.data, thr.ctypes.data, out.ctypes.data, N, F,
            thr.shape[1], int(clamp), 0)
    return out if rc == 0 else None
