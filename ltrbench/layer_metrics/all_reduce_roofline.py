"""Data-parallel collectives: the all-reduce's share of its link
roofline. Per call of ``sum_across`` under a group of n ranks, a ring
all-reduce moves 2(n − 1)/n times the bytes it reduces over each card's
link (NCCL's bus bytes); the least time is those bytes over the link's
peak in one direction, over the collective's own device time
(``collective.split``: the wait for the slowest rank left out). None on a
card whose link peak is not listed here."""

import torch

from ltrbench.layer_metrics.collective import SPAN, count, split  # noqa: F401

LINKS = {
    "NVIDIA H100 80GB HBM3": {
        "bytes_per_s": 450e9,
        "source": "NVIDIA H100 Tensor Core GPU data sheet, SXM5: NVLink "
                  "900 GB/s bidirectional, so 450 GB/s each way",
    },
}


def work(c):
    """Bus bytes of one call."""
    return 2 * (c["n"] - 1) / c["n"] * c["bytes"]


def peak():
    """The link's peak bytes a second of this process's card, or None."""
    if not torch.cuda.is_available():
        return None
    link = LINKS.get(torch.cuda.get_device_name())
    return None if link is None else link["bytes_per_s"]


def read(obs):
    bps = peak()
    got = None if bps is None else split(obs)
    if got is None or got[0] <= 0:
        return None
    return 100.0 * sum(work(c) for c in obs.calls) / bps / got[0]
