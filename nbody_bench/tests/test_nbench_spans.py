"""The readers of the program's spans (``nbody.*``), on a hand-made
``TraceView`` and on a hand-made chrome trace read by ``trace.read``: they
read the segment traced without stacks (``run.trace``), and find nothing
where the program marks no span."""

import json

import pytest

from nbody_bench import metrics, trace
from nbody_bench.harness import Run, Window

STEP = ("nbench.run", "nbody.step")
SPAN_METRICS = ("force_span_ms", "coincident_span_ms", "integrate_span_ms",
                "launches_per_step", "render_span_ms")


def _op(name, seconds, *spans):
    return trace.DeviceOp(name, seconds, frozenset(spans))


def _view(steps=4, frames=2, ops=None):
    if ops is None:
        ops = [
            _op("radixSort", 0.0008, *STEP, "nbody.coincident"),
            _op("elementwise", 0.0002, *STEP, "nbody.coincident"),
            _op("block_forces_kernel", 0.0100, *STEP, "nbody.forces"),
            _op("elementwise", 0.0001, *STEP, "nbody.integrate"),
            _op("elementwise", 0.0001, *STEP, "nbody.integrate"),
            _op("nonzero", 0.1200, "nbench.render", "nbody.render"),
            _op("Memcpy DtoH", 0.0050, "nbench.frame_copy"),
        ]
    return trace.TraceView(window_s=0.2, busy_s=0.15, ops=ops, gaps=[],
                           host_s={}, steps=steps, frames=frames, n=65536)


def _read(name, view):
    return metrics.read(name, Run(window=Window(n=65536), config={},
                                  trace=view))


def test_span_readers_on_the_unstacked_segment():
    v = _view()
    assert _read("force_span_ms", v) == pytest.approx(10.0 / 4)
    assert _read("coincident_span_ms", v) == pytest.approx(1.0 / 4)
    assert _read("integrate_span_ms", v) == pytest.approx(0.2 / 4)
    assert _read("launches_per_step", v) == pytest.approx(5 / 4)
    assert _read("render_span_ms", v) == pytest.approx(120.0 / 2)
    for name in SPAN_METRICS[:4]:
        assert _read(name + ".k2", v) == _read(name, v)


def test_span_readers_ignore_the_stacked_segment():
    """The stack-traced segment (``layers``) is not read: a view whose
    spans lie only there reads nothing."""
    v = _view(ops=[])
    v.layers = _view()
    for name in SPAN_METRICS:
        assert _read(name, v) is None


@pytest.mark.parametrize("view", [
    None,
    _view(steps=0, frames=0),
    # The parent program marks no span: the same kernels under the
    # harness's ranges and the Python functions' names only.
    _view(ops=[_op("block_forces_kernel", 0.01, "nbench.run", "cuda_forces"),
               _op("radixSort", 0.001, "nbench.run", "any_coincident"),
               _op("nonzero", 0.12, "nbench.render", "render_frame")]),
], ids=["no_trace", "no_steps", "no_spans"])
def test_span_readers_find_nothing_to_read(view):
    for name in SPAN_METRICS + tuple(m + ".k2" for m in SPAN_METRICS[:4]):
        assert _read(name, view) is None


def _trace_file(tmp_path):
    """One step of a segment: the harness's ranges, the program's spans,
    three launches and a gap that opens while the host is inside
    ``nbody.coincident``."""
    us = lambda ms: ms * 1000.0  # noqa: E731

    def host(name, cat, t0, t1):
        return {"ph": "X", "cat": cat, "name": name, "tid": 1,
                "ts": us(t0), "dur": us(t1 - t0)}

    def launch(t, corr):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "tid": 1, "ts": us(t), "dur": 5,
                "args": {"correlation": corr}}

    def device(name, cat, t0, t1, corr):
        return {"ph": "X", "cat": cat, "name": name, "tid": 9, "ts": us(t0),
                "dur": us(t1 - t0), "args": {"correlation": corr}}

    ev = [
        host(trace.SEGMENT, "user_annotation", 0, 10),
        host("nbench.run", "user_annotation", 0.1, 9.9),
        host("nbody.step", "user_annotation", 0.2, 9.0),
        host("nbody.coincident", "user_annotation", 0.3, 4.0),
        host("aten::sort", "cpu_op", 0.4, 3.5),
        launch(0.5, 1),
        host("nbody.forces", "user_annotation", 4.0, 5.0),
        launch(4.5, 2),
        host("nbody.integrate", "user_annotation", 5.0, 9.0),
        launch(5.5, 3),
        device("void cub::DeviceRadixSortOnesweepKernel<int>()", "kernel",
               0.6, 1.0, 1),
        device("void block_forces_kernel<float, false>()", "kernel",
               4.6, 6.6, 2),
        device("Memset (Device)", "gpu_memset", 6.6, 6.8, 3),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_spans_through_the_trace_reader(tmp_path):
    v = trace.read(_trace_file(tmp_path))
    v.steps, v.frames = 1, 0
    assert _read("coincident_span_ms", v) == pytest.approx(0.4)
    assert _read("force_span_ms", v) == pytest.approx(2.0)
    assert _read("integrate_span_ms", v) == pytest.approx(0.2)
    assert _read("launches_per_step", v) == 3
    assert _read("render_span_ms", v) is None
    # The device idles from 1.0 ms to 4.6 ms: the host was then inside the
    # flag's span, in a sort, and the gap carries both names.
    gaps = dict(v.gaps)
    assert gaps["nbody.coincident/aten::sort"] == pytest.approx(0.0036)
