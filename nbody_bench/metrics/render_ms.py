"""render_ms: device milliseconds per frame of the operations launched
under ``ops.render.render_frame``.
In the segment traced with Python stacks (``TraceView.layers``).
"""


def read(run):
    t = run.trace and run.trace.layers
    if t is None or t.frames == 0:
        return None
    s = t.device_seconds("render_frame")
    return s / t.frames * 1e3 if s > 0 else None
