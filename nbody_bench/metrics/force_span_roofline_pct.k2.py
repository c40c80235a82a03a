"""force_span_roofline_pct.k2: ``force_roofline_pct.k2`` read from the
program's span in the K2 cells: the least time the card could take for the
force pass (``force_roofline_pct.work``: 20 FLOP per unordered pair at the
float32 peak, or the bodies' bytes at the HBM bandwidth, the larger) over
the device time under ``nbody.forces`` (``force_span_ms``), in percent.  It
moves ``pairs_per_s.k2``, the K2 cells' rate, and reads the segment traced
without Python stacks, as ``force_span_ms.k2`` does."""

from nbody_bench.metrics import force_span_ms, peaks
from nbody_bench.metrics.force_roofline_pct import least_seconds


def read(run):
    t = run.trace
    ms = force_span_ms.read(run)
    peak = peaks(run.device_kind)
    if ms is None or peak is None:
        return None
    return least_seconds(t.n, t.itemsize, peak) / (ms * 1e-3) * 100.0
