"""LETOR / SVMLight-with-qid parser (copy of ranklib_tpu.data.letor.read_letor).

Line format (ref: learning/DataPoint.java:~120):

    <label> qid:<qid> <fid>:<val> <fid>:<val> ... # <description>

* labels are graded relevance floats; feature ids are 1-indexed;
* docs of one query are CONSECUTIVE lines (ref: FeatureManager.readInput,
  features/FeatureManager.java:~60);
* unspecified fids read as 0 with ``missing_zero`` (CLI ``-missingZero``),
  otherwise they are an error (the reference's default);
* ``#`` at a token boundary starts a description kept verbatim;
* gzip files are handled by the Python parser.

Plain files go through the reference's native C++ parser (compiled by path,
``native.loader``); missing compilers and malformed files fall back to the
Python parser, which also owns the precise error messages.
"""

from __future__ import annotations

import numpy as np

from ranklib_tpu_torch.data.dataset import Dataset, Query
from ranklib_tpu_torch.utils.errors import RankLibError
from ranklib_tpu_torch.utils.io import open_text
from ranklib_tpu_torch.utils.logging import log


def _desc_pos(line: str) -> int:
    """Index of the '#' starting the description, or -1. Only a '#' at a
    token boundary (line start or after whitespace) starts one — the
    native parser's rule."""
    pos = line.find("#")
    while pos > 0 and not line[pos - 1].isspace():
        pos = line.find("#", pos + 1)
    return pos


def _parse_line(line: str):
    """Parse one LETOR line → (label, qid, fids, vals, description)."""
    desc = ""
    hash_pos = _desc_pos(line)
    if hash_pos >= 0:
        desc = line[hash_pos:].rstrip()
        line = line[:hash_pos]
    toks = line.split()
    if len(toks) < 2:
        raise RankLibError(f"Unparseable LETOR line: {line!r}")
    try:
        label = float(toks[0])
    except ValueError as e:
        raise RankLibError(f"Bad relevance label in line: {line!r}") from e
    if label < 0:
        raise RankLibError("Relevance label cannot be negative: " + line)
    if not toks[1].startswith("qid:"):
        raise RankLibError(f"Missing qid in line: {line!r}")
    qid = toks[1][4:]
    fids = []
    vals = []
    for t in toks[2:]:
        c = t.find(":")
        if c <= 0:
            raise RankLibError(f"Bad feature token {t!r} in line: {line!r}")
        try:
            fid = int(t[:c])
        except ValueError:
            raise RankLibError(
                f"Bad feature id in token {t!r}: {line!r}") from None
        if fid <= 0:
            raise RankLibError(f"Feature id must be >= 1, got {fid}: {line!r}")
        fids.append(fid)
        try:
            vals.append(float(t[c + 1:]))
        except ValueError:
            raise RankLibError(
                f"Bad feature value in token {t!r}: {line!r}") from None
    return label, qid, fids, vals, desc


def read_letor(path: str, missing_zero: bool = True) -> Dataset:
    """Read a LETOR file into a :class:`Dataset` whose width is the
    file's max fid. ``missing_zero=False`` makes a line that does not
    specify every fid 1..max_fid an error (ref:
    learning/DataPoint.java:~120 missingZero). The reference's
    ``must_have_rel_doc`` and ``n_features`` serve its training flows and
    are not carried.
    """
    from ranklib_tpu_torch.native.loader import (
        NativeParseError, native_parse_letor,
    )
    try:
        parsed = native_parse_letor(path)
    except (NativeParseError, OSError):
        parsed = None          # re-parse in Python for the exact error
    if parsed is not None:
        labels, feats, qptr, qids, descs, counts, max_fid = parsed
        if not missing_zero:
            _check_fully_specified(path, counts, max_fid, qptr, qids)
        queries = [Query(qid=qid, labels=labels[qptr[i]:qptr[i + 1]],
                         feats=feats[qptr[i]:qptr[i + 1]],
                         descs=descs[qptr[i]:qptr[i + 1]])
                   for i, qid in enumerate(qids)]
        return _finish(path, queries, feats.shape[1])

    raw = []  # (qid, (labels, fid_lists, val_lists, descs)) per query
    max_fid = 0
    cur_qid = None
    cur = None
    with open_text(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            label, qid, fids, vals, desc = _parse_line(line)
            if fids:
                max_fid = max(max_fid, max(fids))
            if qid != cur_qid:
                cur = ([], [], [], [])
                raw.append((qid, cur))
                cur_qid = qid
            cur[0].append(label)
            cur[1].append(fids)
            cur[2].append(vals)
            cur[3].append(desc)
    if not missing_zero:
        # raw PAIR count, not distinct fids — the native check's rule
        for qid, (_, fid_lists, _, _) in raw:
            for fids in fid_lists:
                if len(fids) < max_fid:
                    _raise_missing(path, qid, fids, max_fid)
    queries = []
    for qid, (labels, fid_lists, val_lists, descs) in raw:
        feats = np.zeros((len(labels), max_fid), dtype=np.float32)
        for i, (fids, vals) in enumerate(zip(fid_lists, val_lists)):
            if fids:
                feats[i, np.asarray(fids, dtype=np.int64) - 1] = vals
        queries.append(Query(qid=qid,
                             labels=np.asarray(labels, dtype=np.float32),
                             feats=feats, descs=descs))
    return _finish(path, queries, max_fid)


def _raise_missing(path, qid, fids, max_fid):
    have = set(fids)
    missing = next(f for f in range(1, max_fid + 1) if f not in have)
    raise RankLibError(
        f"{path}: qid {qid} does not specify feature {missing} "
        f"(features run 1..{max_fid}); unspecified features are an error "
        f"unless -missingZero is given "
        f"(ref: learning/DataPoint.java missingZero)")


def _check_fully_specified(path, counts, max_fid, qptr, qids):
    """Strict missing-feature check on the native parse: every line must
    carry max_fid fid:val pairs."""
    bad = np.flatnonzero(counts < max_fid)
    if bad.size:
        doc = int(bad[0])
        qi = int(np.searchsorted(qptr, doc, side="right") - 1)
        raise RankLibError(
            f"{path}: qid {qids[qi]} specifies only {int(counts[doc])} of "
            f"{max_fid} features; unspecified features are an error unless "
            f"-missingZero is given (ref: learning/DataPoint.java "
            f"missingZero)")


def _finish(path, queries, n_features) -> Dataset:
    if not queries:
        raise RankLibError(f"No queries read from {path}")
    log(f"Reading feature file [{path}]... [Done.]")
    log(f"({len(queries)} ranked lists, "
        f"{sum(q.n for q in queries)} entries read)")
    return Dataset(queries=queries, n_features=n_features)
