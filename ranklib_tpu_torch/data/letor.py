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

Plain files go through the port's native C++ parser (``native/``, built at
first use by ``native.loader``); missing compilers and malformed files fall
back to the Python parser, which also owns the precise error messages.
:func:`read_descs` is the '#' side-pass of the ``-sparse`` loaders.
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


def read_letor(path: str, missing_zero: bool = True,
               must_have_rel_doc: bool = False,
               n_features: int | None = None) -> Dataset:
    """Read a LETOR file into a :class:`Dataset` whose width is the
    file's max fid, or ``n_features`` when that is wider (a validation or
    test file read into the training width). ``missing_zero=False`` makes
    a line that does not specify every fid 1..max_fid an error (ref:
    learning/DataPoint.java:~120 missingZero). ``must_have_rel_doc`` drops
    queries without a relevant (label > 0) document (ref: Evaluator's
    ``mustHaveRelDoc``, set when the training metric needs one).
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
        if n_features is not None and n_features > feats.shape[1]:
            feats = np.pad(feats, ((0, 0), (0, n_features - feats.shape[1])))
        queries = [Query(qid=qid, labels=labels[qptr[i]:qptr[i + 1]],
                         feats=feats[qptr[i]:qptr[i + 1]],
                         descs=descs[qptr[i]:qptr[i + 1]])
                   for i, qid in enumerate(qids)]
        return _finish(path, queries, feats.shape[1], must_have_rel_doc)

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
    if n_features is not None:
        max_fid = max(max_fid, int(n_features))
    queries = []
    for qid, (labels, fid_lists, val_lists, descs) in raw:
        feats = np.zeros((len(labels), max_fid), dtype=np.float32)
        for i, (fids, vals) in enumerate(zip(fid_lists, val_lists)):
            if fids:
                feats[i, np.asarray(fids, dtype=np.int64) - 1] = vals
        queries.append(Query(qid=qid,
                             labels=np.asarray(labels, dtype=np.float32),
                             feats=feats, descs=descs))
    return _finish(path, queries, max_fid, must_have_rel_doc)


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


def _finish(path, queries, n_features, must_have_rel_doc=False) -> Dataset:
    n_dropped = 0
    if must_have_rel_doc:
        kept = [q for q in queries if (q.labels > 0).any()]
        n_dropped = len(queries) - len(kept)
        queries = kept
    if not queries:
        raise RankLibError(f"No queries read from {path}")
    log(f"Reading feature file [{path}]... [Done.]")
    log(f"({len(queries)} ranked lists, "
        f"{sum(q.n for q in queries)} entries read)")
    if n_dropped:
        log(f"({n_dropped} queries with no relevant documents dropped)")
    return Dataset(queries=queries, n_features=n_features)


def read_descs(path: str, n_docs: int | None = None) -> list:
    """Per-data-line '#' descriptions ('' when absent), file order: the
    side-pass the sparse loaders (CSR and streamed bins) use to carry
    docids for ``-qrel``/``-indri`` without the features (ref:
    learning/SparseDataPoint.java:~15 keeps the description). Native when
    available, streamed Python otherwise (gzip inputs, oversized tokens).
    Verbatim '#...' strings, as the dense parsers keep them."""
    if n_docs is not None and not path.endswith(".gz"):
        from ranklib_tpu_torch.native.loader import (
            NativeParseError, native_letor_descs,
        )
        try:
            descs = native_letor_descs(path, n_docs)
        except (NativeParseError, OSError):
            descs = None
        if descs is not None:
            return descs
    descs = []
    with open_text(path) as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            hp = _desc_pos(s)            # token-boundary '#' (native rule)
            descs.append(s[hp:].rstrip() if hp >= 0 else "")
    if n_docs is not None and len(descs) != n_docs:
        raise RankLibError(
            f"{path}: desc pass saw {len(descs)} data lines, "
            f"expected {n_docs}")
    return descs
