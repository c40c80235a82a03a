"""frame_host_ms: host milliseconds per frame of the copy to the host and
the write into the PPM (``utils.ppm.write_pixels``), from the harness's
ranges around them in the traced segment."""


def read(run):
    t = run.trace
    if t is None or t.frames == 0:
        return None
    s = t.host_s.get("nbench.frame_copy", 0.0) \
        + t.host_s.get("nbench.frame_write", 0.0)
    return s / t.frames * 1e3 if s > 0 else None
