"""enqueue_us_per_step: the host's time to return from ``engine.run``,
per step, over bursts of a few steps each started on an idle device (so
the launch queue never fills and the host never waits for the device);
measured in the traced run with the profiler off."""


def read(run):
    t = run.trace
    if t is None or t.enqueue_steps == 0:
        return None
    return t.enqueue_s / t.enqueue_steps * 1e6
