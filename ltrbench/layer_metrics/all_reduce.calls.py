"""Data-parallel collectives: the program's ``ranklib.all_reduce`` spans
(``gbdt/grow.py`` ``sum_across`` under ``-dp``: histograms, node sums,
leaf sums, metric sums) over its ``ranklib.step`` spans in the traced
span, on rank 0: the all-reduces a round takes."""

from ltrbench.layer_metrics.program import program


def read(obs):
    p = program(obs)
    steps = p.count("step") if p else 0
    if not steps or not p.count("all_reduce"):
        return None
    return p.count("all_reduce") / steps
