"""Validation scoring: the host's kernel launch calls a round inside the
program's ``ranklib.round.validate`` spans (the validation traversal,
its score update and its bucket metric), over the ``ranklib.step``
spans."""

from ltrbench.layer_metrics.program import program


def read(obs):
    p = program(obs)
    if not p or not p.count("round.validate") or not p.count("step"):
        return None
    return p.launches_in("round.validate") / p.count("step")
