"""Lambdas: device ms a round of the kernels launched under the span of
the round's lambda call (``chunk_lambdas``, or the fused
``lambda_round``)."""


def read(obs):
    steps = obs.trace.span_counts.get("step", 0) if obs.trace else 0
    ks = obs.trace.kernels("lambdas") if steps else []
    if not ks:
        return None
    return sum(s for _, s in ks) * 1e3 / steps
