"""force_roofline_pct: the least time the card could take for the force
pass over the time it took (``force_ms``), in percent.

The work is the reference's, whatever computes it: 20 FLOP per unordered
pair (``nr_flops``, nbody-seq.c:367-380), and each body's x, y, mass and
radius read once and its two forces written once.  The least time is the
larger of the FLOP over the float32 peak (the kernels compute in float32
for float32 and bfloat16 states) and the bytes over the HBM bandwidth,
from ``peaks.json`` for the card that ran."""

from nbody_bench.metrics import force_ms, pairs, peaks


def work(n: int, itemsize: int, compute: str = "float32_flops"):
    """(FLOP, bytes, peak key) of one force pass over ``n`` bodies stored
    in ``itemsize``-byte floats."""
    key = "float64_flops" if itemsize == 8 else compute
    return 20 * pairs(n), (4 + 2) * itemsize * n, key


def least_seconds(n: int, itemsize: int, peak: dict) -> float:
    flop, nbytes, key = work(n, itemsize)
    return max(flop / peak[key], nbytes / peak["hbm_bytes_per_s"])


def read(run):
    t = run.trace
    s = force_ms.seconds_per_step(t)
    peak = peaks(run.device_kind)
    if s is None or peak is None:
        return None
    return least_seconds(t.n, t.itemsize, peak) / s * 100.0
