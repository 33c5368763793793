"""RankLib-style console logging (copy of ranklib_tpu.utils.logging).

``log`` prints progress lines unless ``-silent`` (ref:
Ranker.printLogLn, learning/Ranker.java:~200); ``result`` prints final
results regardless; ``event`` appends one JSON record a line to the
``-eventlog`` file when :func:`set_event_log` has opened one (an
extension over RankLib, as in the reference).
"""

from __future__ import annotations

import json
import sys
import time

_SILENT = False
_EVENT_FP = None
_EVENT_PATH = None


def set_silent(silent: bool) -> None:
    global _SILENT
    _SILENT = bool(silent)


def is_silent() -> bool:
    return _SILENT


def set_event_log(path: str | None) -> None:
    """Append JSONL events to *path*, line-buffered (None closes the
    log)."""
    global _EVENT_FP, _EVENT_PATH
    if _EVENT_FP is not None:
        _EVENT_FP.close()
        _EVENT_FP = None
    _EVENT_PATH = path or None
    if path:
        _EVENT_FP = open(path, "a", buffering=1)


def event_log_path() -> str | None:
    """The open event log's path (a ``-dp`` rank 0 appends to it)."""
    return _EVENT_PATH


def log(msg: str = "") -> None:
    """Print a progress line unless silenced (ref: Ranker.printLogLn)."""
    if not _SILENT:
        print(msg, file=sys.stdout, flush=True)


def result(msg: str = "") -> None:
    """Print a FINAL-RESULT line regardless of ``-silent`` (ref:
    eval/Evaluator.java evaluate() tail prints via System.out)."""
    print(msg, file=sys.stdout, flush=True)


def event(kind: str, **fields) -> None:
    """Write ``{"t", "event", **fields}`` to the event log, if one is
    open."""
    if _EVENT_FP is not None:
        rec = {"t": time.time(), "event": kind}
        rec.update(fields)
        _EVENT_FP.write(json.dumps(rec) + "\n")
