"""frame_interval_ms_p90: the 90th percentile of the gaps between
consecutive completed frame writes in the window, over all its frames
(the frame mixes only)."""

import statistics


def read(run):
    t = run.window.frame_times
    if len(t) < 3:
        return None
    gaps = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
    return statistics.quantiles(gaps, n=10, method="inclusive")[-1]
