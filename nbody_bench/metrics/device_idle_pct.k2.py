"""device_idle_pct.k2: ``device_idle_pct`` in the K2 cells; it moves ``pairs_per_s.k2``,
the K2 cells' rate."""

from nbody_bench.metrics.device_idle_pct import read  # noqa: F401
