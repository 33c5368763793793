"""The program's own spans in the traced span's trace, which every
``program_span`` metric of the port's phases reads: ``user_annotation``
events named ``ranklib.<name>`` on the traced thread (the port's
``utils/trace.py`` lists them), and the host's kernel launch calls
among them. A launch call inside ``ltrbench.count`` (the harness's own
counting kernels) is left out, as the trace's device operations leave
out those kernels. A program that opens no such span gives no events,
and the metrics then read nothing."""

from __future__ import annotations

import bisect
import functools

from ltrbench.trace import COUNT, _Nest

PREFIX = "ranklib."
LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx",
                      "cudaGraphLaunch"})


class Program:
    """The program's spans (``spans``: name without the prefix →
    [(start, end)] µs) and the host's launch calls (``launches``: their
    start times, sorted) of one trace."""

    def __init__(self, trace):
        spans, launches = [], []
        for e in trace.others.ev:
            name = str(e.get("name", ""))
            cat = e.get("cat")
            if cat == "user_annotation" and name.startswith(PREFIX):
                spans.append(e)
            elif cat in ("cuda_runtime", "cuda_driver") \
                    and name in LAUNCHES:
                ts = float(e["ts"])
                if COUNT not in trace.host.chain(ts):
                    launches.append(ts)
        self.nest = _Nest(spans)
        self.spans = {}
        for e in spans:
            s = float(e["ts"])
            self.spans.setdefault(e["name"][len(PREFIX):], []).append(
                (s, s + float(e.get("dur", 0.0))))
        self.launches = sorted(launches)

    def count(self, name: str) -> int:
        return len(self.spans.get(name, ()))

    def seconds(self, name: str) -> float:
        return sum(b - a for a, b in self.spans.get(name, ())) * 1e-6

    def launches_in(self, name: str) -> int:
        """Launch calls inside the spans ``name`` (an outer one of the
        same name counts them once)."""
        n = 0
        for a, b in _outermost(self.spans.get(name, ())):
            n += (bisect.bisect_left(self.launches, b)
                  - bisect.bisect_left(self.launches, a))
        return n


def _outermost(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a < out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@functools.lru_cache(maxsize=1)
def _program(trace) -> Program:
    return Program(trace)


def program(obs) -> Program | None:
    """The program's spans of the run's traced span, or None without a
    trace."""
    return None if obs.trace is None else _program(obs.trace)
