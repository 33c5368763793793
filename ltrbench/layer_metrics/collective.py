"""Data-parallel collectives on rank 0's card: each call of the program's
``sum_across`` under a group (span ``all_reduce``) paired with the
collective kernel it launched, in order, and each call's time split into
the collective's own time and the wait for the slowest rank.

A rank's collective kernel starts when that rank reaches the call and
ends when the sum has gone round every rank: its time is the wait for
the last peer to arrive plus the transfer. The transfer of a given size
over the same ranks takes the same time in every call, and no less for
more bytes; in a call that rank 0 reached last it waited for nobody. So
a call's own time is the least kernel time over the traced calls of its
size or larger (a size with few calls, such as the leaf sums' one a
round, borrows the bound of the histograms' many), and the rest of its
kernel time is the wait."""

import torch

SPAN = "all_reduce"


def count(args, kw):
    x = args[0]
    group = args[1] if len(args) > 1 else kw.get("group")
    n = 1 if group is None else torch.distributed.get_world_size(group)
    return {"bytes": x.numel() * x.element_size(), "n": n}


def split(obs):
    """(own seconds, wait seconds, rounds) of the traced calls; None
    where the trace holds no round, or not one collective kernel a
    call."""
    steps = obs.trace.span_counts.get("step", 0) if obs.trace else 0
    ks = ([s for name, s in obs.trace.kernels(SPAN)
           if "nccl" in name.lower()] if steps else [])
    if not ks or len(ks) != len(obs.calls):
        return None
    least = {}
    for c, t in zip(obs.calls, ks):
        key = (c["n"], c["bytes"])
        least[key] = min(t, least.get(key, t))
    bound = {k: min(t for (n, b), t in least.items()
                    if n == k[0] and b >= k[1]) for k in least}
    own = sum(bound[(c["n"], c["bytes"])] for c in obs.calls)
    return own, sum(ks) - own, steps
