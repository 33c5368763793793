"""Device: the share of the untraced window in which no operation runs
on the device. The device's busy time a call is read from the traced
span's trace (the device's own clock, which the profiler's host cost
leaves alone) and set against the window's calls and length on the host
clock, so the profiler's slower host is not counted as idle time."""


def read(obs):
    if obs.trace is None or not obs.traced_calls or not obs.window_calls \
            or obs.window_s <= 0:
        return None
    busy = obs.trace.busy_s / obs.traced_calls * obs.window_calls
    return 100.0 * (1.0 - busy / obs.window_s)
