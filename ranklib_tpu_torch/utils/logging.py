"""RankLib-style console logging (copy of ranklib_tpu.utils.logging).

``log`` prints progress lines unless ``-silent`` (ref:
Ranker.printLogLn, learning/Ranker.java:~200); ``result`` prints final
results regardless. The reference's JSONL event log (``-eventlog``) is not
ported yet.
"""

from __future__ import annotations

import sys

_SILENT = False


def set_silent(silent: bool) -> None:
    global _SILENT
    _SILENT = bool(silent)


def is_silent() -> bool:
    return _SILENT


def log(msg: str = "") -> None:
    """Print a progress line unless silenced (ref: Ranker.printLogLn)."""
    if not _SILENT:
        print(msg, file=sys.stdout, flush=True)


def result(msg: str = "") -> None:
    """Print a FINAL-RESULT line regardless of ``-silent`` (ref:
    eval/Evaluator.java evaluate() tail prints via System.out)."""
    print(msg, file=sys.stdout, flush=True)
