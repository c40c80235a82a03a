"""pairs_per_s.k2: ``pairs_per_s`` in the K2 cells, whose rate spreads
several times less than the K1 cells' rate; kept apart so that each holds
a bound of its own."""

from nbody_bench.metrics.pairs_per_s import read  # noqa: F401
