"""integrate_span_ms: device milliseconds per step of the operations
launched under the program's span ``nbody.integrate``
(``compute_velocities``, ``compute_positions``).
In the segment traced without Python stacks (``run.trace``).
"""

from nbody_bench.metrics.force_span_ms import ms_per_step


def read(run):
    return ms_per_step(run, "nbody.integrate")
