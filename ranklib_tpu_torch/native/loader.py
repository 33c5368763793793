"""ctypes bridge to the port's native LETOR parser and feature binner.

The C++ lives beside this module (``letor_parser.cpp`` and ``binner.cpp``,
which share ``common.h``; copies of the reference's sources). Each file is
compiled with ``g++`` at first use into the port's build directory
(``ops._build``), under a name keyed by the source hash. When a compiler is
missing every entry point returns ``None`` and the callers run their
Python/numpy fallbacks, as the reference's loader does; malformed or
oversized input raises :class:`NativeParseError` so that the caller
re-parses in Python for the precise message.

Entry points: :func:`native_parse_letor` (dense parse),
:func:`native_feature_uniques` and :func:`native_bin_features` (the
training grid and bin matrix), :func:`native_bin_features_transposed`
(serving-upload binning), and the ``-sparse`` passes —
:func:`native_letor_stat`, :func:`native_letor_value_stats` and
:func:`native_parse_letor_binned` (the streamed parse→bin loader),
:func:`native_letor_descs` (the '#' side-array) and
:func:`native_parse_letor_csr` (host CSR) — plus :func:`gunzip_to_temp`.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from ranklib_tpu_torch.utils.errors import RankLibError

_DIR = os.path.dirname(os.path.abspath(__file__))
_COMMON_H = os.path.join(_DIR, "common.h")

QID_STRIDE = 64
DESC_STRIDE = 160

_i64 = ctypes.c_int64
_vp = ctypes.c_void_p


class NativeParseError(Exception):
    pass


def gunzip_to_temp(path: str) -> str:
    """Stream-decompress a .gz file to a temporary file (the caller
    unlinks it). Raises RankLibError with the gzip error on bad
    archives."""
    import gzip
    import shutil
    import tempfile
    import zlib

    with tempfile.NamedTemporaryFile(suffix=".letor", delete=False) as tmp:
        tmp_path = tmp.name
    try:
        with gzip.open(path, "rb") as src, open(tmp_path, "wb") as dst:
            shutil.copyfileobj(src, dst, length=1 << 20)
    except (OSError, EOFError, zlib.error) as e:
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        raise RankLibError(f"cannot decompress {path}: {e}") from None
    return tmp_path


def _compile(name: str, extra_flags=()):
    from ranklib_tpu_torch.ops._build import compile_shared

    try:
        path = compile_shared(
            name, ("g++", "-O3", "-shared", "-fPIC", *extra_flags),
            (os.path.join(_DIR, f"{name}.cpp"),), (_COMMON_H,),
            timeout=120.0)
        return ctypes.CDLL(path)
    except (RankLibError, OSError):
        return None


@functools.cache
def _parser_lib():
    lib = _compile("letor_parser")
    if lib is None:
        return None
    for fn, args in (
            (lib.letor_stat, [ctypes.c_char_p, _vp, _vp, _vp]),
            (lib.letor_fill, [ctypes.c_char_p, _vp, _vp, _i64, _i64, _vp,
                              _i64, ctypes.c_char_p, _i64, ctypes.c_char_p,
                              _i64, _vp]),
            (lib.letor_value_stats, [ctypes.c_char_p, _i64, _i64, _vp, _vp,
                                     _vp]),
            (lib.letor_fill_binned, [ctypes.c_char_p, _vp, _i64, _vp, _vp,
                                     _i64, _i64, _vp, _i64,
                                     ctypes.c_char_p, _i64, _vp]),
            (lib.letor_descs, [ctypes.c_char_p, ctypes.c_char_p, _i64,
                               _i64]),
            (lib.letor_nnz, [ctypes.c_char_p, _vp]),
            (lib.letor_fill_csr, [ctypes.c_char_p, _vp, _i64, _vp, _i64,
                                  ctypes.c_char_p, _i64, _vp, _vp, _i64,
                                  _vp])):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _binner_lib():
    lib = _compile("binner", ("-pthread",))
    if lib is None:
        return None
    for fn in (lib.bin_features_u8_T, lib.bin_features_i16_T):
        fn.argtypes = [_vp, _vp, _vp, _i64, _i64, _i64, _i64, _i64]
        fn.restype = ctypes.c_int
    lib.bin_features_i32.argtypes = [_vp, _vp, _vp, _i64, _i64, _i64, _i64]
    lib.bin_features_i32.restype = ctypes.c_int
    lib.feature_uniques.argtypes = [_vp, _i64, _i64, _i64, _vp, _vp, _vp]
    lib.feature_uniques.restype = ctypes.c_int
    return lib


def _strings(buf, stride: int, n: int, errors: str = "strict") -> list:
    raw = buf.raw                     # .raw copies the buffer — take it ONCE
    return [raw[i * stride:(i + 1) * stride].split(b"\0", 1)[0]
            .decode(errors=errors) for i in range(n)]


def native_parse_letor(path: str):
    """Parse a plain (non-gzip) LETOR file natively.

    Returns (labels[N] f32, feats[N, F] f32, qptr[Q+1] i64, qids list[str],
    descs list[str], counts[N] i32, max_fid int) — F = max_fid, ``counts``
    is the per-line number of fid:val pairs, for the strict
    missing-feature check — or None when the native path is unavailable
    (no compiler, gzip input). Raises NativeParseError on malformed input
    so the caller can re-parse in Python for a precise error message.
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
    return (labels, feats, qptr, _strings(qidbuf, QID_STRIDE, Q),
            _strings(descbuf, DESC_STRIDE, N, "replace"), counts, F)


def native_feature_uniques(feats: np.ndarray, cap: int):
    """One capped-hash pass collecting each feature's unique values
    (binner.cpp ``feature_uniques``). Returns (vals [F, cap] f32, the
    first counts[f] valid and unsorted; counts [F] i64, cap+1 meaning
    "more than cap"; minmax [F, 2] f32 over non-NaN values), or None when
    unavailable (caller runs np.unique)."""
    if cap <= 0 or cap > 400:
        return None
    lib = _binner_lib()
    feats = np.ascontiguousarray(feats, dtype=np.float32)
    N, F = feats.shape
    if lib is None or N == 0:
        return None
    vals = np.empty((F, cap), np.float32)
    counts = np.empty((F,), np.int64)
    minmax = np.empty((F, 2), np.float32)
    rc = lib.feature_uniques(feats.ctypes.data, N, F, cap, vals.ctypes.data,
                             counts.ctypes.data, minmax.ctypes.data)
    return (vals, counts, minmax) if rc == 0 else None


def native_bin_features(feats: np.ndarray, thresholds: np.ndarray):
    """Training binning (binner.cpp ``bin_features_i32``):
    ``searchsorted(thresholds[f], x, 'left')`` for every value, NaN → B.
    Returns [N, F] int32, or None when unavailable (caller runs numpy)."""
    lib = _binner_lib()
    if lib is None:
        return None
    feats = np.ascontiguousarray(feats, dtype=np.float32)
    thr = np.ascontiguousarray(thresholds, dtype=np.float32)
    N, F = feats.shape
    if thr.shape[0] != F:
        return None
    out = np.empty((N, F), np.int32)
    rc = lib.bin_features_i32(feats.ctypes.data, thr.ctypes.data,
                              out.ctypes.data, N, F, thr.shape[1], 0)
    return out if rc == 0 else None


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


# ---- the -sparse passes (letor_parser.cpp) ---------------------------------

def native_letor_stat(path: str):
    """Cheap first pass: (n_docs, n_queries, max_fid), or None when the
    parser is unavailable or the file unreadable."""
    lib = _parser_lib()
    if lib is None:
        return None
    n_docs, n_queries, max_fid = _i64(0), _i64(0), _i64(0)
    rc = lib.letor_stat(path.encode(), ctypes.addressof(n_docs),
                        ctypes.addressof(n_queries),
                        ctypes.addressof(max_fid))
    if rc == -1:
        return None
    if rc != 0:
        raise NativeParseError(f"malformed LETOR file: {path} (rc={rc})")
    return n_docs.value, n_queries.value, max_fid.value


def native_letor_value_stats(path: str, n_feat: int, cap: int):
    """Streamed per-feature capped uniques and min/max, the implicit zeros
    of unspecified fids folded in (the same decisions as the dense
    capped-hash pass). Returns (vals [F, cap] f32, counts [F] i64 with
    cap+1 = over, minmax [F, 2] f32) or None when unavailable."""
    lib = _parser_lib()
    if lib is None or cap <= 0 or cap > 400:
        return None
    vals = np.empty((n_feat, cap), np.float32)
    counts = np.empty((n_feat,), np.int64)
    minmax = np.empty((n_feat, 2), np.float32)
    rc = lib.letor_value_stats(path.encode(), n_feat, cap, vals.ctypes.data,
                               counts.ctypes.data, minmax.ctypes.data)
    if rc == -1:
        return None
    if rc != 0:
        raise NativeParseError(f"streaming stats failed (rc={rc}): {path}")
    return vals, counts, minmax


def native_parse_letor_binned(path: str, thresholds, n_docs: int,
                              n_queries: int):
    """Parse and bin in one stream, with no dense [N, F] f32 matrix.

    Returns (labels [N] f32, bins [N, F] int16, qptr [Q+1] i64,
    qids list[str], counts [N] i32) or None when unavailable."""
    lib = _parser_lib()
    if lib is None:
        return None
    thr = np.ascontiguousarray(thresholds, dtype=np.float32)
    F, B = thr.shape
    labels = np.zeros(n_docs, np.float32)
    bins = np.empty((n_docs, F), np.int16)
    qptr = np.zeros(n_queries + 1, np.int64)
    counts = np.zeros(n_docs, np.int32)
    qidbuf = ctypes.create_string_buffer(n_queries * QID_STRIDE)
    rc = lib.letor_fill_binned(
        path.encode(), thr.ctypes.data, B, labels.ctypes.data,
        bins.ctypes.data, n_docs, F, qptr.ctypes.data, n_queries, qidbuf,
        QID_STRIDE, counts.ctypes.data)
    if rc != 0:
        raise NativeParseError(f"streaming bin failed (rc={rc}): {path}")
    return (labels, bins, qptr, _strings(qidbuf, QID_STRIDE, n_queries),
            counts)


def native_letor_descs(path: str, n_docs: int):
    """Per-data-line '#' descriptions ('' when absent): the side-array the
    sparse loaders attach for -qrel/-indri. Returns list[str] of length
    n_docs, or None when unavailable. Raises NativeParseError on
    oversized tokens so the caller can run the Python pass."""
    lib = _parser_lib()
    if lib is None:
        return None
    descbuf = ctypes.create_string_buffer(n_docs * DESC_STRIDE)
    rc = lib.letor_descs(path.encode(), descbuf, DESC_STRIDE, n_docs)
    if rc == -1:
        return None
    if rc != 0:
        raise NativeParseError(f"desc pass failed (rc={rc}): {path}")
    return _strings(descbuf, DESC_STRIDE, n_docs, "replace")


def native_parse_letor_csr(path: str):
    """Parse a LETOR file straight into host CSR.

    Returns (labels[N] f32, qptr[Q+1] i64, qids list[str],
    indptr[N+1] i64, fids[nnz] i32 0-based, vals[nnz] f32,
    counts[N] i32, max_fid int) — memory ~ nnz, never [N, F] — or None
    when the native path is unavailable. Raises NativeParseError on
    malformed or oversized input so the caller can fall back to the
    Python parser for the exact error message.
    """
    lib = _parser_lib()
    if lib is None:
        return None
    stat = native_letor_stat(path)
    if stat is None:
        return None
    N, Q, max_fid = stat
    if N == 0 or Q == 0:
        raise NativeParseError(f"no data lines in {path}")
    nnz = _i64(0)
    rc = lib.letor_nnz(path.encode(), ctypes.addressof(nnz))
    if rc == -1:
        return None
    if rc == -4:
        raise NativeParseError(f"oversized token in {path}")
    if rc != 0:
        raise NativeParseError(f"malformed LETOR file: {path}")
    nnz = nnz.value
    labels = np.zeros(N, np.float32)
    qptr = np.zeros(Q + 1, np.int64)
    counts = np.zeros(N, np.int32)
    fids = np.zeros(nnz, np.int32)
    vals = np.zeros(nnz, np.float32)
    qidbuf = ctypes.create_string_buffer(Q * QID_STRIDE)
    rc = lib.letor_fill_csr(path.encode(), labels.ctypes.data, N,
                            qptr.ctypes.data, Q, qidbuf, QID_STRIDE,
                            fids.ctypes.data, vals.ctypes.data, nnz,
                            counts.ctypes.data)
    if rc == -4:
        raise NativeParseError(f"oversized token in {path}")
    if rc != 0:
        raise NativeParseError(f"native CSR parse failed (rc={rc}): {path}")
    indptr = np.zeros(N + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return (labels, qptr, _strings(qidbuf, QID_STRIDE, Q), indptr, fids,
            vals, counts, max_fid)
