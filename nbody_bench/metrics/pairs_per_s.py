"""pairs_per_s: unordered pairs n(n-1)/2 times every step completed in the
window, over the window's synchronized wall time, frames included."""

from nbody_bench.metrics import pairs


def read(run):
    w = run.window
    if w.seconds <= 0 or w.steps == 0:
        return None
    return pairs(w.n) * w.steps / w.seconds
