"""step_mfu: the whole step's share of the card's float32 peak, in
percent: the reference's FLOP model of a step (``nr_flops``,
nbody-seq.c:367-380) times the steps of the traced segment, over the
segment's length (frames included) and the peak in ``peaks.json``."""

from nbody_bench.metrics import nr_flops, peaks


def read(run):
    t = run.trace
    peak = peaks(run.device_kind)
    if t is None or t.steps == 0 or t.window_s <= 0 or peak is None:
        return None
    key = "float64_flops" if t.itemsize == 8 else "float32_flops"
    return nr_flops(t.n) * t.steps / t.window_s / peak[key] * 100.0
