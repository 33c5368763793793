"""Model step: CUDA kernels launched a step (a LambdaMART round, or a
Random Forests group step) in the traced span."""


def read(obs):
    steps = obs.trace.span_counts.get("step", 0) if obs.trace else 0
    ks = obs.trace.kernels("step") if steps else []
    if not ks:
        return None
    return len(ks) / steps
