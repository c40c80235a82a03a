"""enqueue_us_per_step.k2: ``enqueue_us_per_step`` in the K2 cells; it moves ``pairs_per_s.k2``,
the K2 cells' rate."""

from nbody_bench.metrics.enqueue_us_per_step import read  # noqa: F401
