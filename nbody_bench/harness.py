"""One run of one cell: inputs from the seed, set-up, the measured window,
the traced segment, and the check.

A cell names a configuration (``configs/<config>.json``: the bodies, the
arena, the physics constants, the port's ``SimConfig`` fields and
``chunk_steps``) and a traffic mix (``traffic/<mix>.json``: the init law of
``inputs/`` with its ``law_seed`` and ``relabel``, and ``frame_every``, the
steps between frames, or null).  The
window is a closed loop: one simulation stepping as fast as it can through
``models.engine.run`` in chunks, one chunk queued ahead of the one the
harness waits on.  With frames, every ``frame_every`` steps the harness
renders (``ops.render.render_frame``), copies the frame to the host and
writes it into one PPM under ``TMPDIR`` (``utils.ppm.write_pixels``), as the
CLI does.  The window ends at the first chunk boundary after ``seconds``,
with one more step whose input and output the check keeps, and a
synchronize.  After the window, the check also runs one chunk from that
input in one call and the same steps one call at a time.

With ``trace`` the window starts by timing the host's enqueue of short
bursts (``ENQUEUE_SECONDS``, no profiler), then profiles two segments of
``TRACE_SECONDS`` under ``torch.profiler``: the first as the program runs
(busy and idle time, the breakdown, the host's frame path), the second with
Python stacks recorded, which slow the host but tie each kernel to the
port's function that launched it (the layers' device times); then it runs
on as usual.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import record_function

from parallel_nbody_tpu_torch.config import SimConfig
from parallel_nbody_tpu_torch.models import engine
from parallel_nbody_tpu_torch.ops.render import render_frame
from parallel_nbody_tpu_torch.state import State
from parallel_nbody_tpu_torch.utils import ppm as ppmio

from . import check, inputs, metrics, trace as tracing

TRACE_SECONDS = 1.5
ENQUEUE_SECONDS = 2.0
# Steps in one enqueue burst: few enough launches that the host never
# waits for room in the device's launch queue.
ENQUEUE_BURST = 4
# Imported top-level names that must not be in the process: JAX and the
# JAX package, compared whole (the port's name begins with the latter's).
FORBIDDEN = ("jax", "jaxlib", "flax", "parallel_nbody_tpu")
_SIM_FIELDS = ("xdim", "ydim", "gravity", "friction", "dt", "force_mode",
               "dtype", "kernel", "accum")


def forbidden_modules(names=None) -> list:
    """The top-level names of ``names`` (default: ``sys.modules``) that are
    in ``FORBIDDEN``, each compared whole."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    """A workload of the manifest, with its files read."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # manifest entries of the cell's metrics
    per_layer: list
    metrics_dir: str

    @property
    def sim(self) -> SimConfig:
        return SimConfig(**{k: self.config[k] for k in _SIM_FIELDS})


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(manifest_path: str, workload: str,
              overrides: dict | None = None) -> Cell:
    """The cell ``workload`` of the manifest at ``manifest_path``; its
    configuration is the manifest's ``file``, relative to the manifest, and
    the rest lies beside the ``configs/`` folder that holds it:
    ``traffic/<mix>.json``, ``limits/<cell>.json`` and ``metrics/``.
    ``overrides`` replaces configuration fields (the tests' small
    sizes)."""
    root = os.path.dirname(os.path.abspath(manifest_path))
    with open(manifest_path) as f:
        manifest = json.load(f)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError("no workload %r in %s" % (workload, manifest_path))
    w = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    conf_path = os.path.join(root, conf["file"])
    bench = os.path.dirname(os.path.dirname(conf_path))
    with open(conf_path) as f:
        config = json.load(f)
    config.update(overrides or {})
    with open(os.path.join(bench, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    with open(os.path.join(bench, "limits", workload + ".json")) as f:
        limits = json.load(f)
    return Cell(workload, config, traffic, limits,
                [m for m in manifest["end_to_end"] if _applies(m, workload)],
                [m for m in manifest["per_layer"] if _applies(m, workload)],
                os.path.join(bench, "metrics"))


@dataclasses.dataclass
class Window:
    """What the host clock saw of the measured window."""

    n: int
    steps: int = 0
    seconds: float = 0.0
    setup_s: float = 0.0
    frame_times: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Run:
    """What a metric's reader gets: the window, the cell's configuration,
    and in a traced run the segment's ``trace.TraceView``."""

    window: Window
    config: dict
    device_kind: str = ""
    trace: object = None


class _Sim:
    """The program under test, driven in chunks, with the frame path."""

    def __init__(self, cell: Cell, state: State, device):
        self.cfg = cell.sim
        self.k = int(cell.traffic.get("frame_every")
                     or cell.config["chunk_steps"])
        self.frames = bool(cell.traffic.get("frame_every"))
        self.device = device
        self.state = state
        self.steps = 0
        self.frame_times = []
        self.frame_state = None
        self.ppm = None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def event(self):
        """A marker after the work queued so far; ``.synchronize()`` waits
        for it (on the CPU the work is already done)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def advance(self, steps: int):
        with record_function("nbench.run"):
            self.state = engine.run(self.cfg, self.state, steps)
        self.steps += steps

    def frame(self):
        s = self.state
        with record_function("nbench.render"):
            pixels = render_frame(self.cfg, s.x, s.y, s.radius, s.x.shape[0])
        with record_function("nbench.frame_copy"):
            host = pixels.cpu().numpy()
        with record_function("nbench.frame_write"):
            ppmio.write_pixels(self.ppm, host)
        self.frame_times.append(time.perf_counter())
        self.frame_state = s

    def drive(self, until: float):
        """Chunks (each followed by a frame in frame mixes) until the first
        chunk boundary at or after ``until`` (perf_counter seconds); without
        frames one chunk stays queued ahead of the one waited on.  Returns
        with the last chunk possibly still in flight."""
        if self.frames:
            while True:
                self.advance(self.k)
                self.frame()
                if time.perf_counter() >= until:
                    return
        self.advance(self.k)
        done = self.event()
        while True:
            self.advance(self.k)
            ahead = self.event()
            if done is not None:
                done.synchronize()
            done = ahead
            if time.perf_counter() >= until:
                return


def _to64(t):
    return t.detach().to(torch.float64)


def _host_answer(s: State, rows=None) -> dict:
    """The answer's fields in float64 on the host, of the bodies ``rows``
    (all when None)."""
    def pick(t):
        return t if rows is None else t[rows.to(t.device)]
    return {k: _to64(pick(getattr(s, k))).cpu()
            for k in ("x", "y", "xv", "yv", "xf", "yf")}


def _chunk_gap(cfg, prev: State, k: int) -> float:
    """``check.state_gap`` between ``engine.run`` of ``k`` steps from
    ``prev`` in one call and the same ``k`` steps one call at a time."""
    whole = engine.run(cfg, State(*(t.clone() for t in prev)), k)
    one = prev
    for _ in range(k):
        one = engine.run(cfg, one, 1)
    return check.state_gap(whole, one)


def _read_frame(path: str, xdim: int, ydim: int) -> np.ndarray:
    """The frame's bytes as written, read back from the file (an empty
    frame, which fails the check, if the file is not that frame's PPM)."""
    with open(path, "rb") as f:
        data = f.read()
    header = b"P6\n%d %d\n255\n" % (xdim, ydim)
    if not data.startswith(header) or \
            len(data) != len(header) + xdim * ydim * 3:
        return np.zeros((0, 0, 3), np.uint8)
    return np.frombuffer(data[len(header):], np.uint8).reshape(ydim, xdim, 3)


def _enqueue_probe(sim: _Sim, seconds: float) -> tuple:
    """(host seconds, steps): the host's time to return from
    ``engine.run`` of ``ENQUEUE_BURST`` steps, each burst started on an
    idle device, for about ``seconds`` of wall time."""
    host, steps = 0.0, 0
    stop = time.perf_counter() + seconds
    while time.perf_counter() < stop or steps == 0:
        sim.sync()
        t = time.perf_counter()
        sim.advance(ENQUEUE_BURST)
        host += time.perf_counter() - t
        steps += ENQUEUE_BURST
    sim.sync()
    return host, steps


def power_limit_w():
    """The card's power limit in watts from ``nvidia-smi``, or None."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float | None = None, control=None) -> dict:
    """One run of ``cell``; returns the result line's object.

    ``t_start`` is the process's start on the perf_counter clock (set-up
    is counted from it).  ``control``, when given, is called as
    ``control(cell, prev, frame_state)`` on the device state that the
    window's last step started from (and the last frame's state, or None),
    before the state is freed; it returns answers to hold to the same
    reference, and the result then carries their readings under
    ``control``, and under ``control_correct`` whether they pass the
    cell's limits as the program's readings must.

    ``phases`` (in the result) splits the set-up: ``imports`` (from
    ``t_start``), ``device`` (the card's context), ``inputs``,
    ``first_step`` (the kernels' build or load, and the first launches),
    ``warm`` (the rest of a chunk and a frame)."""
    t_start = time.perf_counter() if t_start is None else t_start
    phases = {"imports": time.perf_counter() - t_start}
    tick = time.perf_counter()

    def phase(name):
        nonlocal tick
        now = time.perf_counter()
        phases[name] = now - tick
        tick = now

    if device.type == "cuda":
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
    phase("device")
    conf = cell.config
    n, dtype = int(conf["n"]), cell.sim.torch_dtype
    rows = check.sample_rows(n, seed, conf.get("check_rows"))
    arrays = inputs.make(cell.traffic, n, conf["xdim"], conf["ydim"], seed)
    # Rounded once to the run's dtype: the same values go to both sides.
    x, y, xv, yv, mass, radius = (torch.from_numpy(a).to(dtype)
                                  for a in arrays)
    zeros = torch.zeros(n, dtype=dtype)
    state = State(*(t.to(device) for t in (x, y, xv, yv, zeros, zeros,
                                            mass, radius)))
    phase("inputs")
    start_prev = {k: _to64(t) for k, t in zip(("x", "y", "xv", "yv"),
                                              (x, y, xv, yv))}
    sim = _Sim(cell, state, device)
    tmp = []
    try:
        # Set-up: the build at first use, the first step (kept for the
        # check), the rest of a chunk, and a frame in frame mixes.
        sim.advance(1)
        start_ans = _host_answer(sim.state, rows)
        phase("first_step")
        sim.advance(sim.k - 1)
        if sim.frames:
            fd, path = tempfile.mkstemp(suffix=".ppm", prefix="nbench_")
            os.close(fd)
            tmp.append(path)
            sim.ppm = ppmio.create(path, conf["xdim"], conf["ydim"])
            sim.frame()
            sim.frame_times.clear()
        sim.sync()
        phase("warm")
        sim.steps = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        view = None
        if trace:
            enqueue = _enqueue_probe(sim, ENQUEUE_SECONDS)
            view = _traced_segment(sim, tmp, tracing.SEGMENT, False)
            view.layers = _traced_segment(sim, tmp, tracing.LAYERS, True)
            view.enqueue_s, view.enqueue_steps = enqueue
        sim.drive(deadline)
        prev = sim.state
        sim.advance(1)
        sim.sync()
        t1 = time.perf_counter()
        window = Window(n=n, steps=sim.steps, seconds=t1 - t0,
                        setup_s=t0 - t_start,
                        frame_times=list(sim.frame_times))
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        chunk_gap = _chunk_gap(sim.cfg, prev, sim.k)
        control_ans = None
        if control is not None:
            control_ans = control(cell, prev, sim.frame_state)
        end_prev = {k: _to64(getattr(prev, k)).cpu()
                    for k in ("x", "y", "xv", "yv")}
        end_ans = _host_answer(sim.state, rows)
        frame_x = frame_y = None
        if sim.frames:
            frame_x = _to64(sim.frame_state.x).cpu()
            frame_y = _to64(sim.frame_state.y).cpu()
        carried = float((sim.state.mass.cpu() != mass).sum()
                        + (sim.state.radius.cpu() != radius).sum())
        sim.state = sim.frame_state = prev = state = None
        if device.type == "cuda":
            torch.cuda.empty_cache()
        # The reference, after the window, on the device in float64.
        t_ref = time.perf_counter()
        readings, control_readings = _readings(
            cell, device, mass, radius, start_prev, start_ans, end_prev,
            end_ans, frame_x, frame_y, tmp[0] if sim.frames else None,
            carried, control_ans, rows)
        readings["chunk_gap.end"] = chunk_gap
        reference_s = time.perf_counter() - t_ref
    finally:
        for path in tmp:
            if os.path.exists(path):
                os.remove(path)
    checks = check.judge(readings, cell.limits)
    correct = check.passed(checks)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    record = Run(window=window, config=conf, device_kind=dev["kind"],
                 trace=view)
    values = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        v = metrics.read(m["name"], record, cell.metrics_dir)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    if device.type == "cuda":
        dev["power_limit_w"] = power_limit_w()
    if view is not None:
        dev["busy_s"] = view.busy_s
        dev["window_s"] = view.window_s
    failed = sum(
        any(not (c["value"] <= c["limit"]) for k, c in checks.items()
            if k.endswith(where))
        for where in (".start", ".end", ".frame"))
    out = {"correct": correct,
           "attempted": window.steps + len(window.frame_times),
           "failed": failed,
           "metrics": values, "device": dev}
    if view is not None:
        out["breakdown"] = view.breakdown()
    if control_readings is not None:
        out["control"] = control_readings
        out["control_correct"] = check.passed(
            check.judge(control_readings, cell.limits))
    out["reference_s"] = reference_s
    out["phases"] = phases
    out["checks"] = checks
    return out


def _readings(cell, device, mass, radius, start_prev, start_ans, end_prev,
              end_ans, frame_x, frame_y, frame_path, carried, control_ans,
              rows=None):
    """(the program's readings, the control's or None), each
    ``{"<number>.<where>": value}``, against the float64 reference on the
    card (on the CPU without one); the step answers hold the bodies
    ``rows`` (all when None), the control's step answer every body."""
    conf = cell.config
    ref_dev = device if device.type == "cuda" else torch.device("cpu")

    def dev64(d):
        return {k: v.to(ref_dev, torch.float64) for k, v in d.items()}

    m64, r64 = _to64(mass).to(ref_dev), _to64(radius).to(ref_dev)
    ref_rows = None if rows is None else rows.to(ref_dev)
    m_rows = m64 if rows is None else m64[ref_rows]
    out = {}
    ref = check.reference_step(dev64(start_prev), m64, r64, conf, ref_rows)
    for k, v in check.step_gaps(dev64(start_ans), ref, m_rows,
                                conf).items():
        out[k + ".start"] = v
    ref = check.reference_step(dev64(end_prev), m64, r64, conf, ref_rows)
    for k, v in check.step_gaps(dev64(end_ans), ref, m_rows, conf).items():
        out[k + ".end"] = v
    controls = {}
    if control_ans is not None and "step" in control_ans:
        step = control_ans["step"]
        if rows is not None:
            step = {k: v[rows] for k, v in step.items()}
        for k, v in check.step_gaps(dev64(step), ref, m_rows,
                                    conf).items():
            controls[k + ".end"] = v
    del ref
    if frame_path is not None:
        ref_frame = check.reference_module(conf).frame(
            frame_x.to(ref_dev), frame_y.to(ref_dev), r64, conf["xdim"],
            conf["ydim"]).cpu().numpy()
        out["frame_pixels.frame"] = check.frame_pixels(
            _read_frame(frame_path, conf["xdim"], conf["ydim"]), ref_frame)
        if control_ans is not None and "frame" in control_ans:
            controls["frame_pixels.frame"] = check.frame_pixels(
                control_ans["frame"], ref_frame)
    out["carried_changed.end"] = carried
    return out, (controls if control_ans is not None else None)


def _traced_segment(sim: _Sim, tmp: list, name: str, stacks: bool):
    """Profile ``TRACE_SECONDS`` of the window's loop as the range ``name``
    and read the trace.  One unit runs under the profiler before the range
    opens, so the profiler's own start-up stays outside it.  With
    ``stacks`` the profiler records Python calls, which ties each kernel to
    the port's function that launched it but slows the host."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if sim.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, with_stack=stacks)
    prof.start()
    try:
        sim.advance(sim.k)
        if sim.frames:
            sim.frame()
        sim.sync()
        steps0, frames0 = sim.steps, len(sim.frame_times)
        with record_function(name):
            sim.drive(time.perf_counter() + TRACE_SECONDS)
            sim.sync()
        steps, frames = sim.steps - steps0, len(sim.frame_times) - frames0
    finally:
        prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="nbench_trace_")
    os.close(fd)
    tmp.append(path)
    prof.export_chrome_trace(path)
    view = tracing.read(path, name)
    os.remove(path)
    view.steps, view.frames = steps, frames
    view.n, view.itemsize = sim.state.x.shape[0], sim.state.x.element_size()
    return view
