"""force_span_ms: device milliseconds per step of the operations launched
under the program's span ``nbody.forces`` (K1, or K2's row launches and
fold; ``ops.cuda_step.forces_coincident_dispatch``).
In the segment traced without Python stacks (``run.trace``), as the
program runs.
"""


def ms_per_step(run, span):
    """Device milliseconds per step under the program's span ``span``, or
    None where the segment holds no step or nothing ran under it (the span
    is absent: the program does not mark that layer)."""
    t = run.trace
    if t is None or t.steps == 0:
        return None
    s = t.device_seconds(span)
    return s / t.steps * 1e3 if s > 0 else None


def read(run):
    return ms_per_step(run, "nbody.forces")
