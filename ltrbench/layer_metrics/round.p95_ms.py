"""Round loop: the 95th percentile of the spacing between round ends,
from CUDA events recorded on the stream after each round of the window
(no host sync); at least 20 spacings."""

import statistics


def read(obs):
    gaps = obs.call_gaps_ms
    if len(gaps) < 20:
        return None
    return statistics.quantiles(gaps, n=20)[18]
