"""coincident_ms: device milliseconds per step of the operations launched
under ``ops.cuda_step.any_coincident`` (three stable sorts and the compare
that make the step's coincidence flag).
In the segment traced with Python stacks (``TraceView.layers``).
"""


def read(run):
    t = run.trace and run.trace.layers
    if t is None or t.steps == 0:
        return None
    s = t.device_seconds("any_coincident")
    return s / t.steps * 1e3 if s > 0 else None
