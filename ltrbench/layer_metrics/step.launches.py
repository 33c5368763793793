"""Host launch path: the host's kernel launch calls (``cudaLaunchKernel``
and its kin, ``cudaGraphLaunch``) inside the program's ``ranklib.step``
spans (a LambdaMART round, a Random Forests group step), over their
number. ``step.kernels`` counts the kernels the device ran; a step
replayed as a CUDA graph lowers this count and leaves that one."""

from ltrbench.layer_metrics.program import program


def read(obs):
    p = program(obs)
    steps = p.count("step") if p else 0
    if not steps:
        return None
    return p.launches_in("step") / steps
