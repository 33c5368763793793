"""Split-scan kernel B2 (``ops/split_scan.py`` ``best_splits`` →
``csrc/split_scan.cu``): per call, the [nodes, F, B, 2] f32 histogram
read once, the [nodes, F] feature mask when given, and each node's
gain, feature, bin and flag written; nine operations a bin (two prefix
adds, two right-side subtractions, two squares, two divisions, one
add)."""

import torch

from ltrbench.layer_metrics.roofline import share

SPAN = "split_scan"


def count(args, kw):
    hist = args[0]
    fmask = args[2] if len(args) > 2 else kw.get("fmask")
    parts = hist if isinstance(hist, (tuple, list)) else (hist,)
    nodes = sum(int(h.shape[0]) for h in parts)
    _, F, B, _ = parts[0].shape
    return {"nodes": nodes, "F": int(F), "B": int(B),
            "mask": isinstance(fmask, torch.Tensor)}


def work(c):
    n, F, B = c["nodes"], c["F"], c["B"]
    return (n * F * B * 8 + (n * F if c["mask"] else 0) + n * 13,
            n * F * B * 9)


def read(obs):
    return share(obs, SPAN, work)
