"""launches_per_step: device operations (kernels, copies, sets) launched
under the program's span ``nbody.step``, per step of the segment traced
without Python stacks (``run.trace``).  A count: the kernel boundaries of a
step, which a change that fuses kernels moves first.
"""


def read(run):
    t = run.trace
    if t is None or t.steps == 0:
        return None
    k = sum(1 for op in t.ops if "nbody.step" in op.spans)
    return k / t.steps if k else None
