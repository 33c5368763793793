"""Histogram kernel B1 (``ops/histogram.py`` ``histogram`` →
``csrc/histogram.cu``): per call, the docs its mask holds x features x
id width, plus (grad, weight) f32 per such doc, plus the [F, B, 2] f32
output; two adds per doc and feature and one multiply per doc."""

import torch

from ltrbench.layer_metrics.roofline import share

SPAN = "histogram"


def count(args, kw):
    binned_T, _, mask, n_bins = args[:4]
    F, _ = binned_T.shape
    return {"docs": torch.count_nonzero(mask), "F": F, "B": int(n_bins),
            "id_bytes": binned_T.element_size()}


def work(c):
    n, F = c["docs"], c["F"]
    return (n * F * c["id_bytes"] + n * 8 + F * c["B"] * 8,
            n * (2 * F + 1))


def read(obs):
    return share(obs, SPAN, work)
