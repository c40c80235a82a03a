"""pairs_per_s.frames: ``pairs_per_s`` in the frame cells, where the
host's frame path (render, copy, write) sits inside the window and spreads
the rate more than the kernel cells'; kept apart so that those hold a
tighter bound."""

from nbody_bench.metrics.pairs_per_s import read  # noqa: F401
