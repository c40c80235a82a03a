"""integrate_ms: device milliseconds per step of the operations launched
under ``ops.integrate`` (``compute_velocities``, ``compute_positions``).
In the segment traced with Python stacks (``TraceView.layers``).
"""


def read(run):
    t = run.trace and run.trace.layers
    if t is None or t.steps == 0:
        return None
    s = t.device_seconds("compute_velocities", "compute_positions")
    return s / t.steps * 1e3 if s > 0 else None
