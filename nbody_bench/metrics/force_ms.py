"""force_ms: device milliseconds per step of the operations launched under
the force pass (``ops.cuda_step.cuda_forces``: K1 ``csrc/forces.cu``, K2
``csrc/forces_streamed.cu``).
In the segment traced with Python stacks (``TraceView.layers``).
"""

SPANS = ("cuda_forces", "streamed_forces", "block_forces",
         "block_forces_streamed")


def seconds_per_step(t):
    t = t and t.layers
    if t is None or t.steps == 0:
        return None
    s = t.device_seconds(*SPANS)
    return s / t.steps if s > 0 else None


def read(run):
    s = seconds_per_step(run.trace)
    return None if s is None else s * 1e3
