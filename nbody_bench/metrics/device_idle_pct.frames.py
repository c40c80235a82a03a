"""device_idle_pct.frames: ``device_idle_pct`` in the frame cells, where
the device waits while the host copies and writes each frame; it moves
``pairs_per_s.frames``."""

from nbody_bench.metrics.device_idle_pct import read  # noqa: F401
