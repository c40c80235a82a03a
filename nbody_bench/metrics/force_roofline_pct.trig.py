"""force_roofline_pct.trig: the least time the card could take for the
parity pass over the time it took (``force_span_ms``), in percent.

The work is the reference's, whatever computes it
(``force_roofline_pct.work``): 20 FLOP per unordered pair (``nr_flops``,
nbody-seq.c:367-380) at the card's float64 peak, or each body's x, y, mass
and radius read once and its two forces written once at the HBM bandwidth,
whichever takes longer, from ``peaks.json``.  It reads a few percent by
construction: the reference's model counts each of a pair's atan2, cos and
sin as one FLOP, and the pass computes them in float64, each a polynomial
of tens of FP64 instructions, for each of the N^2 ordered pairs."""

from nbody_bench.metrics import force_span_ms, peaks
from nbody_bench.metrics.force_roofline_pct import least_seconds


def read(run):
    t = run.trace
    ms = force_span_ms.read(run)
    peak = peaks(run.device_kind)
    if ms is None or peak is None:
        return None
    return least_seconds(t.n, t.itemsize, peak) / (ms * 1e-3) * 100.0
