"""Host-device boundary: the program's device-to-host reads
(``ranklib.host_read`` spans) a call of the traced span. A program that
opens no ``ranklib.step`` span reads nothing here: it marks no reads
either."""

from ltrbench.layer_metrics.program import program


def read(obs):
    p = program(obs)
    if not p or not p.count("step") or not obs.traced_calls:
        return None
    return p.count("host_read") / obs.traced_calls
