"""Multi-bag histogram kernel B7 (``ops/histogram.py``
``histogram_multi`` → ``csrc/histogram_multi.cu``): per call, the ids
of the docs that any bag's weights hold, read once (docs x features x
id width), (grad, weight) f32 per bag and doc it holds, and the
[C, F, B, 2] f32 output; two adds per bag, doc and feature and one
multiply per bag and doc."""

import torch

from ltrbench.layer_metrics.roofline import share

SPAN = "histogram_multi"


def count(args, kw):
    binned_T, grads, weights, n_bins = args[:4]
    held = weights != 0
    return {"docs": torch.count_nonzero(held.any(dim=0)),
            "pairs": torch.count_nonzero(held), "C": grads.shape[0],
            "F": binned_T.shape[0], "B": int(n_bins),
            "id_bytes": binned_T.element_size()}


def work(c):
    F = c["F"]
    return (c["docs"] * F * c["id_bytes"] + c["pairs"] * 8
            + c["C"] * F * c["B"] * 8,
            c["pairs"] * (2 * F + 1))


def read(obs):
    return share(obs, SPAN, work)
