"""step_mfu.k2: ``step_mfu`` in the K2 cells; it moves ``pairs_per_s.k2``,
the K2 cells' rate."""

from nbody_bench.metrics.step_mfu import read  # noqa: F401
