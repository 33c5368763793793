"""Data-parallel collectives: device ms a round in which rank 0's
collective kernels wait for the slowest rank to reach the call (the
kernels' time less their own, ``collective.split``): how far the ranks
drift apart within a round."""

from ltrbench.layer_metrics.collective import SPAN, count, split  # noqa: F401


def read(obs):
    got = split(obs)
    return None if got is None else got[1] * 1e3 / got[2]
