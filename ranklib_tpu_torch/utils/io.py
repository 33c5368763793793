"""Gzip-capable text opening (copy of ranklib_tpu.utils.io.open_text)."""

from __future__ import annotations

import gzip


def open_text(path: str, mode: str = "rt"):
    """Open *path* as text; transparently handles ``.gz`` files."""
    if path.endswith(".gz"):
        return gzip.open(path, mode if "t" in mode else mode + "t")
    return open(path, mode)
