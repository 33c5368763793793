"""The roofline share that every ``*_roofline`` metric reports: the
least time the card could take for the calls' work, the larger of bytes
over the peak bandwidth and operations over the peak f32 rate (each
input byte read once, each output byte written once), over the device
time of the kernels under the calls' span."""


def share(obs, span: str, work):
    """``work(call)`` → (bytes, ops) of one of the metric's recorded calls
    of ``span`` (``obs.calls``); None without a peak for this card, calls
    or kernel time."""
    calls = obs.calls
    if obs.peak is None or obs.trace is None or not calls:
        return None
    t = sum(s for _, s in obs.trace.kernels(span))
    if t <= 0:
        return None
    least = 0.0
    for c in calls:
        nbytes, ops = work(c)
        least += max(nbytes / obs.peak["bytes_per_s"],
                     ops / obs.peak["f32_ops_per_s"])
    return 100.0 * least / t
