"""External relevance judgments, ``-qrel <file>`` (copy of
ranklib_tpu.data.qrel).

TREC qrel format, one judgment per line::

    <qid> <iteration> <docid> <relevance>

The iteration column is ignored. Docids are matched against each doc's
``#`` description: either the whole trimmed comment (``# GX008-86``) or
the value of a ``docid = X`` assignment inside it (MSLR/LETOR style
``#docid = GX008-86 inc = ...``). Judged docs get the qrel label,
unjudged docs 0.
"""

from __future__ import annotations

import re

import numpy as np

from ranklib_tpu_torch.data.dataset import Dataset
from ranklib_tpu_torch.utils.errors import RankLibError
from ranklib_tpu_torch.utils.io import open_text
from ranklib_tpu_torch.utils.logging import log


def read_qrel(path: str) -> dict:
    """(qid, docid) → relevance float."""
    out = {}
    with open_text(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if len(parts) < 4:
                raise RankLibError(f"Bad qrel line: {line.rstrip()!r}")
            qid, _, docid, rel = parts[0], parts[1], parts[2], parts[3]
            out[(qid, docid)] = float(rel)
    if not out:
        raise RankLibError(f"No judgments read from {path}")
    return out


_DOCID_RE = re.compile(r"(?<!\w)docid\s*=\s*(\S+)", re.IGNORECASE)


def doc_id(desc: str) -> str:
    """Docid from a '#' description; '' when absent.

    The 'docid = X' form matches at a word boundary with the '=' bound to
    that very token, so '# mydocid = GX1 docid = GX2' gives 'GX2' and
    'docidentifier ...' is no assignment. Anything else: the first
    whitespace token."""
    body = desc.lstrip("#").strip()
    if not body:
        return ""
    m = _DOCID_RE.search(body)
    if m:
        return m.group(1)
    return body.split()[0]


def apply_qrel(ds: Dataset, path: str) -> None:
    """Overwrite labels in place from a qrel file (unjudged → 0)."""
    qrel = read_qrel(path)
    # per query: a doc without a '#' description can match no judgment, so
    # its whole query would silently read as unjudged
    for q in ds.queries:
        if not q.descs or not all(q.descs):
            raise RankLibError(
                f"-qrel needs per-doc '#' descriptions, but qid {q.qid} "
                f"has docs without one (was the file loaded without "
                f"descriptions, or are some lines uncommented?)")
    n_hit = 0
    for q in ds.queries:
        labels = np.zeros_like(q.labels)
        for i in range(q.n):
            d = doc_id(q.descs[i])
            if (q.qid, d) in qrel:
                labels[i] = qrel[(q.qid, d)]
                n_hit += 1
        q.labels[:] = labels
    log(f"Relevance judgments loaded from {path} "
        f"({n_hit} of {ds.n_docs} docs judged)")
