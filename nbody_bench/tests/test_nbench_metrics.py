"""The metrics' arithmetic, the roofline's work count, and the trace
reader on a hand-made chrome trace."""

import json

import pytest

from nbody_bench import metrics, trace
from nbody_bench.harness import Run, Window
from nbody_bench.metrics import force_roofline_pct

H100 = "NVIDIA H100 80GB HBM3"


def test_work_counts_the_references_pairs():
    flop, nbytes, key = force_roofline_pct.work(65536, 4)
    assert flop == 20 * 65536 * 65535 // 2
    assert nbytes == 24 * 65536 and key == "float32_flops"
    peak = metrics.peaks(H100)
    # 20 FLOP per unordered pair at 67 TFLOP/s bounds a pass at 65536.
    least = force_roofline_pct.least_seconds(65536, 4, peak)
    assert least == pytest.approx(20 * 2147450880 / 67e12)
    assert force_roofline_pct.least_seconds(8, 4, peak) == \
        pytest.approx(24 * 8 / 3.35e12)  # few bodies: bytes bound
    assert metrics.peaks("a card not in the table") is None


def _view(**kw):
    v = trace.TraceView(window_s=2.0, busy_s=1.9, ops=[
        trace.DeviceOp("block_forces_kernel", 0.50,
                       frozenset({"nbench.run", "cuda_forces"})),
        trace.DeviceOp("radixSort", 0.10,
                       frozenset({"nbench.run", "any_coincident"})),
        trace.DeviceOp("elementwise", 0.02,
                       frozenset({"nbench.run", "compute_velocities"})),
        trace.DeviceOp("elementwise", 0.03,
                       frozenset({"nbench.run", "compute_positions"})),
        trace.DeviceOp("nonzero", 0.20,
                       frozenset({"nbench.render", "render_frame"}))],
        gaps=[("nbench.frame_write/write_pixels", 0.05)],
        host_s={"nbench.frame_copy": 0.004, "nbench.frame_write": 0.006},
        steps=200, frames=2, enqueue_s=0.05, enqueue_steps=400, n=65536,
        itemsize=4)
    v.layers = v  # one segment serves as both here
    for k, val in kw.items():
        setattr(v, k, val)
    return v


def _read(name, view=None, window=None):
    run = Run(window=window or Window(n=65536), config={},
              device_kind=H100, trace=view)
    return metrics.read(name, run)


def test_per_layer_readers():
    v = _view()
    assert _read("force_ms", v) == pytest.approx(2.5)
    assert _read("coincident_ms", v) == pytest.approx(0.5)
    assert _read("integrate_ms", v) == pytest.approx(0.25)
    assert _read("render_ms", v) == pytest.approx(100.0)
    assert _read("frame_host_ms", v) == pytest.approx(5.0)
    assert _read("device_idle_pct", v) == pytest.approx(5.0)
    assert _read("enqueue_us_per_step", v) == pytest.approx(125.0)
    least = 20 * 2147450880 / 67e12
    assert _read("force_roofline_pct", v) == pytest.approx(
        least / 2.5e-3 * 100)
    flop = 20 * 2147450880 + 22 * 65536
    assert _read("step_mfu", v) == pytest.approx(
        flop * 200 / 2.0 / 67e12 * 100)


def test_readers_find_nothing_to_read():
    v = _view(frames=0, ops=[], busy_s=0.0)
    for name in ("force_ms", "force_roofline_pct", "coincident_ms",
                 "render_ms", "frame_host_ms", "device_idle_pct"):
        assert _read(name, v) is None
        assert _read(name, None) is None
    assert _read("frame_interval_ms_p90", None, Window(n=8)) is None
    assert _read("force_ms", _view(layers=None)) is None


def test_end_to_end_readers():
    w = Window(n=65536, steps=1000, seconds=3.0, setup_s=7.5,
               frame_times=[0.25 * i + (0.05 if i == 7 else 0.0)
                            for i in range(21)])
    assert _read("pairs_per_s", None, w) == pytest.approx(
        2147450880 * 1000 / 3.0)
    assert _read("setup_s", None, w) == 7.5
    # 20 gaps of 250 ms, two of them moved by 50 ms: p90 lies between.
    assert 250.0 <= _read("frame_interval_ms_p90", None, w) <= 300.0


def test_trace_reader_ties_kernels_to_their_spans(tmp_path):
    us = lambda ms: ms * 1000.0  # noqa: E731
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.SEGMENT,
         "tid": 1, "ts": us(0), "dur": us(10)},
        {"ph": "X", "cat": "python_function", "tid": 1,
         "name": "ops/cuda_step.py(429): cuda_forces", "ts": us(1),
         "dur": us(1)},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": us(1.5), "dur": 5, "args": {"correlation": 7}},
        {"ph": "X", "cat": "python_function", "tid": 1,
         "name": "ops/cuda_step.py(451): any_coincident", "ts": us(2.5),
         "dur": us(0.5)},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": us(2.7), "dur": 5, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "void block_forces_kernel<f>()",
         "tid": 9, "ts": us(2), "dur": us(4), "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "radixSort<int>",
         "tid": 9, "ts": us(6), "dur": us(1), "args": {"correlation": 8}},
        {"ph": "X", "cat": "python_function", "tid": 1,
         "name": "utils/ppm.py(98): write_pixels", "ts": us(6.9),
         "dur": us(2)},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    v = trace.read(str(path))
    assert v.window_s == pytest.approx(0.010)
    assert v.busy_s == pytest.approx(0.005)
    assert v.device_seconds("cuda_forces") == pytest.approx(0.004)
    assert v.device_seconds("any_coincident") == pytest.approx(0.001)
    assert v.gaps[0][0] == "nbench.segment/write_pixels"
    assert v.gaps[0][1] == pytest.approx(0.003)
    b = v.breakdown()
    assert b["device_ops"][0] == ["block_forces_kernel", pytest.approx(0.004)]
    assert len(b["idle_gaps"]) == 2
