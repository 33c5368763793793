"""Data-parallel collectives: the collective's own device ms a round on
rank 0's card, each call at the least kernel time of the traced calls of
its size or larger (``collective.split``): the transfer, without the
wait for the slowest rank (``all_reduce.wait_ms``)."""

from ltrbench.layer_metrics.collective import SPAN, count, split  # noqa: F401


def read(obs):
    got = split(obs)
    return None if got is None else got[0] * 1e3 / got[2]
