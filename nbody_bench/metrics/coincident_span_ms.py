"""coincident_span_ms: device milliseconds per step of the operations
launched under the program's span ``nbody.coincident`` (the coincidence
flag's three stable sorts and its compare).
In the segment traced without Python stacks (``run.trace``).
"""

from nbody_bench.metrics.force_span_ms import ms_per_step


def read(run):
    return ms_per_step(run, "nbody.coincident")
