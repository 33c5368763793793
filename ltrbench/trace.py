"""The traced span: ``torch.profiler`` over the program's calls, spans
from this benchmark's own wrappers around the calls into each layer, and
the reduction of the profiler's trace to what the per-layer metrics read.

Every wrapped call runs inside ``record_function("ltrbench.<span>")``.
A per-layer metric that counts a call's work (a roofline's bytes and
operations) names the span and gives a ``count(args, kwargs)``; the
counts that need the device run on a side stream, inside the span
``ltrbench.count``, whose kernels the reduction leaves out.

The trace is the profiler's Chrome trace. A kernel belongs to the spans
that enclose its launch on the host (the launch is found by the
kernel's correlation id).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import shutil
import tempfile
from collections import defaultdict

import torch

PREFIX = "ltrbench."
COUNT = PREFIX + "count"
WINDOW = PREFIX + "window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Recorder:
    """The traced span's call records: each counting metric's counts of
    the calls of its span."""

    def __init__(self, counters: dict, device):
        self.counters = counters          # span → [(metric, count)]
        self.device = device
        self.calls = defaultdict(list)    # metric → [{key: value}]
        self.side = (torch.cuda.Stream(device) if device.type == "cuda"
                     else None)

    def wrap(self, name: str, orig):
        counters = self.counters.get(name, ())
        rec = self

        def wrapper(*args, **kw):
            with torch.profiler.record_function(PREFIX + name):
                out = orig(*args, **kw)
                if counters:
                    rec._count(counters, args, kw)
            return out

        return wrapper

    def _count(self, counters, args, kw):
        with torch.profiler.record_function(COUNT):
            if self.side is None:
                for metric, fn in counters:
                    self.calls[metric].append(fn(args, kw))
                return
            self.side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.side):
                for metric, fn in counters:
                    self.calls[metric].append(fn(args, kw))
            for t in _tensors((args, kw)):
                t.record_stream(self.side)

    def resolved(self) -> dict:
        """The calls' counts with every tensor read back (after the
        span)."""
        return {k: [{n: (float(v) if isinstance(v, torch.Tensor) else v)
                     for n, v in c.items()} for c in calls]
                for k, calls in self.calls.items()}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


@contextlib.contextmanager
def profiled(cuda: bool = True):
    """Profile the block (CPU and, with ``cuda``, CUDA activity) inside
    the span ``ltrbench.window``; yields a dict that holds, after the
    block, the reduced :class:`Trace` under ``"trace"``. The Chrome trace
    is written to a temporary directory and removed."""
    from torch.profiler import ProfilerActivity, profile, record_function

    box = {}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield box
            if cuda:
                torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="ltrbench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        box["trace"] = Trace.load(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class Trace:
    """The reduced trace of one traced span."""

    def __init__(self, events: list):
        xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
        win = [e for e in xs if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if not win:
            raise ValueError("the trace holds no ltrbench.window span")
        w = win[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.main = (w.get("pid"), w.get("tid"))
        cpu = [e for e in xs if (e.get("pid"), e.get("tid")) == self.main
               and e.get("cat") not in DEVICE_CATS]
        spans = [e for e in cpu if e.get("cat") == "user_annotation"
                 and str(e.get("name", "")).startswith(PREFIX)]
        host = _Nest(spans)
        launch_spans = {}
        for e in xs:
            corr = e.get("args", {}).get("correlation")
            if corr is not None and e.get("cat") in ("cuda_runtime",
                                                     "cuda_driver"):
                launch_spans[corr] = host.chain(float(e["ts"]))
        self.ops = []                 # (cat, name, ts, dur, spans)
        for e in xs:
            if e.get("cat") not in DEVICE_CATS:
                continue
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            sp = launch_spans.get(e.get("args", {}).get("correlation"), ())
            if COUNT in sp:
                continue
            self.ops.append((e["cat"], str(e.get("name", "")), ts, dur, sp))
        self.ops.sort(key=lambda o: o[2])
        self.host = host
        ids = {id(e) for e in spans}
        self.others = _Nest([e for e in cpu if id(e) not in ids])
        self.span_counts = defaultdict(int)
        for e in spans:
            self.span_counts[e["name"][len(PREFIX):]] += 1

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _busy(self):
        """Merged device-busy intervals inside the window (µs)."""
        out = []
        for _, _, ts, dur, _ in self.ops:
            a, b = max(ts, self.t0), min(ts + dur, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy()) * 1e-6

    def kernels(self, span: str | None = None) -> list:
        """(name, seconds) of the kernels under ``span`` (all without
        one)."""
        return [(name, dur * 1e-6) for cat, name, _, dur, sp in self.ops
                if cat == "kernel" and (span is None or PREFIX + span in sp)]

    def device_ops(self, top: int = 10) -> list:
        tot = defaultdict(float)
        for _, name, _, dur, _ in self.ops:
            tot[_short(name)] += dur * 1e-6
        return sorted(tot.items(), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """The idle device time by what the host was doing: each gap is
        cut at the benchmark spans' edges, and each piece is named by the
        innermost span and the innermost host event (op or runtime call)
        at its middle."""
        gaps, prev = [], self.t0
        for a, b in self._busy():
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        edges = sorted(set(self.host.starts) | set(self.host.ends))
        tot = defaultdict(float)
        for a, b in gaps:
            cut = edges[bisect.bisect_right(edges, a):
                        bisect.bisect_left(edges, b)]
            for lo, hi in zip([a] + cut, cut + [b]):
                mid = (lo + hi) / 2
                sp = self.host.chain(mid)
                inner = self.others.chain(mid)
                label = (sp[-1][len(PREFIX):] if sp else "(none)") + \
                    ("/" + _short(inner[-1]) if inner else "")
                tot[label] += (hi - lo) * 1e-6
        return sorted(tot.items(), key=lambda kv: -kv[1])[:top]


def _short(name: str, n: int = 96) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


class _Nest:
    """Events of one thread, which nest, indexed for the question: which
    of them hold time ``t``?"""

    def __init__(self, events: list):
        self.ev = sorted(events, key=lambda e: (float(e["ts"]),
                                                -float(e.get("dur", 0.0))))
        self.starts = [float(e["ts"]) for e in self.ev]
        self.ends = [s + float(e.get("dur", 0.0))
                     for s, e in zip(self.starts, self.ev)]
        self.parent = []
        stack = []
        for i, s in enumerate(self.starts):
            while stack and self.ends[stack[-1]] <= s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def chain(self, t: float) -> tuple:
        """Names of the events that hold ``t``, outermost first."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and not self.ends[i] > t:
            i = self.parent[i]
        out = []
        while i >= 0:
            out.append(self.ev[i]["name"])
            i = self.parent[i]
        return tuple(reversed(out))
