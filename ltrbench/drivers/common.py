"""What every driver shares: the program's dataset from the generated
arrays, spans around the program's calls, and the window's loop.

A driver (``Driver(cfg, train, vali, device)``) builds the program's
objects and warms them up in its constructor (set-up), then offers:

* ``window(seconds, events)`` → :class:`Window`: the program's calls,
  one after another, until ``seconds`` have passed; the call in flight
  finishes and counts;
* ``traced_calls()``: the calls of the traced span (after the window);
* ``spans()``: [(module, attribute, span name)] of the program's calls to
  wrap in the traced span;
* ``outputs()``: host copies of what the program produced, for the
  judge; ``close()`` frees the program's state.

Beside the class the module offers ``judge(ctx, outputs, cfg, seed)`` →
{number: value}, and ``control(ctx, cfg, seed, dtype)``: the reference's
own outputs in ``dtype``, in the form of ``outputs()``.

A multi-card driver (a cell whose ``chips`` is n > 1) is built in each
of n worker processes, one a card, with the environment ``torchrun``
gives (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``); it joins the program's group itself
(``ranklib_tpu_torch.parallel.dist.join()``) and leaves it in
``close()``. Its ``Window.work`` counts the whole fit's work on every
rank, not the rank's shard's: ``train_rate`` is rank 0's work over rank
0's window. Its ranks run the same collectives, so they end the window
at the same call: they decide it together (a "time is up" flag carried
in a call's collective), never each by its own clock, as
:func:`run_window` does. Only rank 0's ``outputs()`` is judged, so it
holds every rank's part of what the judge reads.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class Window:
    calls: int                 # whole calls the window ran
    work: float                # doc·trees they did
    seconds: float             # host clock, from a synchronised start to
                               # the synchronised end of the last call
    ends: list = field(default_factory=list)   # CUDA events after calls


def dataset(split):
    """The program's ``Dataset`` over a generated split: one ``Query`` a
    list, whose arrays are views of the split's."""
    from ranklib_tpu_torch.data.dataset import Dataset, Query

    qs = []
    for i in range(split.n_queries):
        lo, hi = int(split.qptr[i]), int(split.qptr[i + 1])
        qs.append(Query(str(i + 1), split.labels[lo:hi], split.feats[lo:hi]))
    return Dataset(qs, split.feats.shape[1])


def run_window(call, seconds: float, work_per_call: float,
               events: bool, device) -> Window:
    """``call()`` until ``seconds`` have passed on the host clock; the
    window ends when the device has finished the last call. With
    ``events``, a CUDA event is recorded on the stream after each call
    (no host sync)."""
    ends = []
    sync(device)
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        call()
        n += 1
        if events:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ends.append(ev)
    sync(device)
    return Window(n, n * work_per_call, time.perf_counter() - t0, ends)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def wrapped(targets, wrap):
    """Inside the block, each ``(owner, attribute, name)`` of ``targets``
    is replaced by ``wrap(name, original)``; restored after."""
    saved = []
    try:
        for owner, attr, name in targets:
            orig = getattr(owner, attr)
            saved.append((owner, attr, orig))
            setattr(owner, attr, wrap(name, orig))
        yield
    finally:
        for owner, attr, orig in reversed(saved):
            setattr(owner, attr, orig)


def to_ref_tree(t):
    """The program's exported tree as the reference's ``Tree``."""
    from ltrbench.reference.tree import Tree

    return Tree(np.asarray(t.feature), np.asarray(t.threshold, np.float32),
                np.asarray(t.left), np.asarray(t.right),
                np.asarray(t.is_leaf, bool), np.asarray(t.output, np.float32))
