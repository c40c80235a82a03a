"""force_ms.k2: ``force_ms`` in the K2 cells; it moves ``pairs_per_s.k2``,
the K2 cells' rate."""

from nbody_bench.metrics.force_ms import read  # noqa: F401
