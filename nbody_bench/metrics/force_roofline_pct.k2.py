"""force_roofline_pct.k2: ``force_roofline_pct`` in the K2 cells; it moves ``pairs_per_s.k2``,
the K2 cells' rate."""

from nbody_bench.metrics.force_roofline_pct import read  # noqa: F401
