"""render_span_ms: device milliseconds per frame of the operations launched
under the program's span ``nbody.render`` (``ops.render.render_frame``).
In the segment traced without Python stacks (``run.trace``).
"""


def read(run):
    t = run.trace
    if t is None or t.frames == 0:
        return None
    s = t.device_seconds("nbody.render")
    return s / t.frames * 1e3 if s > 0 else None
