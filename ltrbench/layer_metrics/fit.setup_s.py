"""Fit set-up of a Random Forests fit: host seconds a call of the
program's ``ranklib.fit.setup`` spans (binning, padding, the transpose,
the upload, the bag draws and the doc-to-query map: everything before
the first group step), on the profiler's clock."""

from ltrbench.layer_metrics.program import program


def read(obs):
    p = program(obs)
    if not p or not p.count("fit.setup") or not obs.traced_calls:
        return None
    return p.seconds("fit.setup") / obs.traced_calls
