"""The port's diagnostics against the JAX package: state validation and the
per-field printers, ``--check-nans``, ``--trace`` and the program's spans
(``utils.timing.span``), recorded trajectories and the energy diagnostic.
Inputs are the glibc init or numpy arrays from a seed, handed to both
packages.
"""

import glob
import gzip
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_nbody_tpu.cli as jcli
import parallel_nbody_tpu.utils.debug as jdebug
from parallel_nbody_tpu.config import SimConfig as JaxConfig
from parallel_nbody_tpu.models import engine as jengine
from parallel_nbody_tpu.state import State as JState
from parallel_nbody_tpu.state import init_state as jax_init_state
from parallel_nbody_tpu_torch import cli
from parallel_nbody_tpu_torch.config import SimConfig
from parallel_nbody_tpu_torch.models import engine
from parallel_nbody_tpu_torch.ops.render import render_frame
from parallel_nbody_tpu_torch.state import State, init_state
from parallel_nbody_tpu_torch.utils import checkpoint as ckpt
from parallel_nbody_tpu_torch.utils import debug, ppm, timing
from parallel_nbody_tpu_torch.utils.output import format_state

torch.set_num_threads(1)

CFG = SimConfig(dtype="float64")
JCFG = JaxConfig(dtype="float64")


def _to_jax(st):
    return JState(*(jnp.asarray(t.numpy()) for t in st))


def _main(main, argv, capsys, monkeypatch):
    monkeypatch.setenv("NBODY_PLATFORM", "cpu")
    capsys.readouterr()
    rc = main(["nbody"] + argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.fixture
def arena(tmp_path):
    p = str(tmp_path / "arena.ppm")
    ppm.create(p, 256, 192)
    return p


# ---------------------------------------------------------------------------
# validate_state and the printers
# ---------------------------------------------------------------------------

def _poisoned(case):
    st = engine.run(CFG, init_state(8, CFG), 3)
    if case == "clean":
        return st
    if case == "nan_xv":
        xv = st.xv.clone()
        xv[3] = float("nan")
        return st._replace(xv=xv)
    if case == "inf_yf_nan_mass":
        yf, mass = st.yf.clone(), st.mass.clone()
        yf[0], mass[7] = float("inf"), float("nan")
        return st._replace(yf=yf, mass=mass)
    x = st.x.clone()
    x[0] = {"out_of_bounds": 99999.0, "just_inside": CFG.xdim - 0.5,
            "on_the_wall": float(CFG.xdim), "negative": -0.25}[case]
    return st._replace(x=x)


@pytest.mark.parametrize("case", ["clean", "nan_xv", "inf_yf_nan_mass",
                                  "out_of_bounds", "just_inside",
                                  "on_the_wall", "negative"])
def test_validate_state_equals_jax(case):
    st = _poisoned(case)
    got = debug.validate_state(st, CFG.xdim, CFG.ydim)
    want = jdebug.validate_state(_to_jax(st), JCFG.xdim, JCFG.ydim)
    assert (got.n, got.finite, got.nan_fields, got.pos_in_bounds) == \
        (want.n, want.finite, want.nan_fields, want.pos_in_bounds)
    assert got.ok() == want.ok()
    for a, b in ((got.max_speed, want.max_speed),
                 (got.max_force, want.max_force)):
        assert (np.isnan(a) and np.isnan(b)) or a == b


def test_validate_state_verdicts():
    assert debug.validate_state(_poisoned("clean"), 1024, 768).ok()
    d = debug.validate_state(_poisoned("nan_xv"), 1024, 768)
    assert not d.ok() and d.nan_fields == ["xv"]
    d = debug.validate_state(_poisoned("inf_yf_nan_mass"))
    assert d.nan_fields == ["yf", "mass"] and d.pos_in_bounds
    assert not debug.validate_state(_poisoned("on_the_wall"), 1024,
                                    768).pos_in_bounds
    assert debug.validate_state(_poisoned("just_inside"), 1024,
                                768).pos_in_bounds
    empty = State(*(torch.zeros(0, dtype=torch.float64) for _ in range(8)))
    d = debug.validate_state(empty, 10, 10)
    assert (d.n, d.max_speed, d.max_force) == (0, 0.0, 0.0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_per_field_printers_equal_jax(dtype):
    cfg, jcfg = SimConfig(dtype=dtype), JaxConfig(dtype=dtype)
    st = engine.run(cfg, init_state(6, cfg), 4)
    jst = jengine.run(jcfg, jax_init_state(6, jcfg), 4)
    for name in ("format_positions", "format_velocities", "format_forces"):
        assert getattr(debug, name)(st) == getattr(jdebug, name)(_to_jax(st))
    if dtype == "float64":
        assert debug.format_forces(st) == jdebug.format_forces(jst)
    full = [l.split() for l in format_state(st).splitlines()]
    assert [l.split() for l in debug.format_positions(st).splitlines()] == \
        [f[0:2] for f in full]
    assert [l.split() for l in debug.format_forces(st).splitlines()] == \
        [f[2:4] for f in full]
    assert [l.split() for l in debug.format_velocities(st).splitlines()] == \
        [f[4:6] for f in full]


# ---------------------------------------------------------------------------
# --check-nans
# ---------------------------------------------------------------------------

def test_check_finite_names_fields_and_step():
    debug.check_finite(_poisoned("clean"), 7)
    with pytest.raises(FloatingPointError, match=r"yf,mass after step 12$"):
        debug.check_finite(_poisoned("inf_yf_nan_mass"), 12)


def test_run_checks_every_step_from_the_given_count():
    """A NaN mass turns that body's fields non-finite in the first step:
    the checked run stops there and names the step counted from
    ``nan_check_from``; the unchecked run goes on."""
    st = init_state(8, CFG)
    mass = st.mass.clone()
    mass[2] = float("nan")
    bad = st._replace(mass=mass)
    with pytest.raises(FloatingPointError, match=r"after step 41$") as e:
        engine.run(CFG, bad, 5, nan_check_from=40)
    assert "mass" in str(e.value) and "xf" in str(e.value)
    out = engine.run(CFG, bad, 5)
    assert not bool(torch.isfinite(out.xf).all())
    clean = engine.run(CFG, st, 5, nan_check_from=0)
    assert format_state(clean) == format_state(engine.run(CFG, st, 5))


def test_cli_check_nans_clean_run_as_jax(arena, capsys, monkeypatch):
    argv = ["16", "0", arena, "5", "--check-nans"]
    rc, out, err = _main(cli.main, argv, capsys, monkeypatch)
    try:
        jrc, jout, jerr = _main(jcli.main, argv + ["--devices=1"], capsys,
                                monkeypatch)
    finally:
        import jax
        jax.config.update("jax_debug_nans", False)
    assert rc == jrc == 0 and out == jout
    line = [l for l in err.splitlines() if l.startswith("State validation")]
    jline = [l for l in jerr.splitlines() if l.startswith("State validation")]
    assert line == jline and len(line) == 1
    assert line[0].startswith("State validation ok: max|v|=")
    assert line[0].endswith("in_bounds=True")
    _, plain, _ = _main(cli.main, argv[:-1], capsys, monkeypatch)
    assert out == plain


def _poisoned_checkpoint(tmp_path, field):
    st = engine.run(CFG, init_state(16, CFG), 5)
    t = getattr(st, field).clone()
    t[4] = float("nan")
    path = str(tmp_path / "poisoned.npz")
    ckpt.save_state(path, st._replace(**{field: t}), 5)
    return path


def test_cli_check_nans_poisoned_run_raises_naming_field_and_step(
        arena, tmp_path, capsys, monkeypatch):
    ck = _poisoned_checkpoint(tmp_path, "xv")
    monkeypatch.setenv("NBODY_PLATFORM", "cpu")
    with pytest.raises(FloatingPointError,
                       match=r"non-finite values in x,y,xv,yv after step 6$"):
        cli.main(["nbody", "16", "0", arena, "9", "--resume=" + ck,
                  "--check-nans"])
    # Without the flag the run goes to its end and prints the NaN.
    rc, out, _ = _main(cli.main, ["16", "0", arena, "9", "--resume=" + ck],
                       capsys, monkeypatch)
    assert rc == 0 and "nan" in out


def test_cli_check_nans_poisoned_state_exits_1_naming_field(
        arena, tmp_path, capsys, monkeypatch):
    """Resumed at its own step the state takes no step; the end-of-run
    validation names the field and the CLI exits 1 before printing."""
    ck = _poisoned_checkpoint(tmp_path, "yv")
    rc, out, err = _main(cli.main, ["16", "0", arena, "5", "--resume=" + ck,
                                    "--check-nans"], capsys, monkeypatch)
    assert rc == 1 and out == ""
    assert "State validation FAILED: NaNs in yv\n" in err


# ---------------------------------------------------------------------------
# Spans and traces
# ---------------------------------------------------------------------------

def _events(log_dir):
    (path,) = glob.glob(os.path.join(log_dir, "**", "*.trace.json.gz"),
                        recursive=True)
    with gzip.open(path, "rt") as f:
        return json.load(f)["traceEvents"]


def test_profiler_trace_writes_events(tmp_path):
    log_dir = str(tmp_path / "trace")
    with timing.trace(log_dir):
        engine.run(CFG, init_state(16, CFG), 5)
    ops = [e for e in _events(log_dir) if e.get("cat") == "cpu_op"]
    assert any(e["name"].startswith("aten::") for e in ops)
    share = timing.trace_comm_share(log_dir)
    assert share["op_us"] > 0 and share["collective_us"] == 0.0
    assert share["share"] == 0.0 and share["by_op"] == {}
    # Leaves only: the sum stays below the sum over every operator, which
    # counts nested ones twice, and within the traced wall time.
    assert share["op_us"] < sum(e["dur"] for e in ops)


def _spans(events):
    """The program's spans in a trace: name -> [(start, end)] in us."""
    out = {}
    for e in events:
        if e.get("cat") == "user_annotation" and \
                e["name"].startswith("nbody."):
            out.setdefault(e["name"], []).append((e["ts"],
                                                  e["ts"] + e["dur"]))
    return out


def _inside(span, spans):
    """How many of ``spans`` hold ``span`` whole."""
    return sum(a <= span[0] and span[1] <= b for a, b in spans)


KERNEL_CFG = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
TRIG_CFG = SimConfig(force_mode="trig", dtype="float64", kernel="cuda")


@pytest.mark.parametrize("path", ["cuda", "dense", "hosted", "trig"])
def test_trace_holds_the_programs_spans(path, tmp_path):
    """Three steps: three ``nbody.step`` spans, each holding one
    ``nbody.forces`` and one ``nbody.integrate`` (and on K1's and K2's path
    one ``nbody.coincident``; the parity pass, like the dense path, runs no
    flag) that do not overlap; one ``nbody.render`` a frame, outside every
    step."""
    n = 64
    cfg = {"dense": CFG, "trig": TRIG_CFG}.get(path, KERNEL_CFG)
    st = init_state(n, cfg)
    log_dir = str(tmp_path / "trace")
    with timing.trace(log_dir):
        if path == "hosted":
            step_fn, _ = engine.make_hosted_row_step(cfg, n)
            for _ in range(3):
                st = step_fn(st)
        else:
            st = engine.run(cfg, st, 3)
        render_frame(cfg, st.x, st.y, st.radius, n)
    spans = _spans(_events(log_dir))
    children = ["nbody.forces", "nbody.integrate"]
    if path in ("cuda", "hosted"):
        children.insert(0, "nbody.coincident")
    assert sorted(spans) == sorted(children + ["nbody.step", "nbody.render"])
    assert len(spans["nbody.step"]) == 3 and len(spans["nbody.render"]) == 1
    for step in spans["nbody.step"]:
        mine = sorted(s for name in children for s in spans[name]
                      if _inside(s, [step]))
        assert len(mine) == len(children)
        assert all(a[1] <= b[0] for a, b in zip(mine, mine[1:]))
    for name in children:
        assert len(spans[name]) == 3
        assert all(_inside(s, spans["nbody.step"]) == 1 for s in spans[name])
    assert _inside(spans["nbody.render"][0], spans["nbody.step"]) == 0


def test_no_profiler_builds_no_span(monkeypatch):
    """With no profiler recording, a step and a frame construct no
    ``record_function``: ``span`` hands out one shared no-op context."""
    def refuse(name):
        raise AssertionError("record_function(%r) with no profiler" % name)

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    for cfg in (KERNEL_CFG, CFG):
        st = engine.run(cfg, init_state(32, cfg), 2)
        render_frame(cfg, st.x, st.y, st.radius, 32)
    assert timing.span("nbody.step") is timing.span("nbody.render")


def test_span_gate_opens_under_profile_start(tmp_path):
    """A profiler started by ``profile(...).start()``, as the benchmark
    starts one, opens the gate; its trace holds the span; after ``stop``
    the gate is shut again."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        on = timing.span("nbody.test")
        with on:
            torch.ones(8).sum()
    finally:
        prof.stop()
    assert isinstance(on, torch.profiler.record_function)
    assert timing.span("nbody.test") is timing.span("nbody.step")
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert len(_spans(events)["nbody.test"]) == 1


def test_cli_trace_holds_step_and_frame_spans(arena, tmp_path, capsys,
                                              monkeypatch):
    """``--trace=DIR`` with frames: one ``nbody.step`` a step, and each
    frame's render, copy to the host and write in that order, outside the
    steps."""
    d = str(tmp_path / "trace")
    rc, out, err = _main(cli.main, ["32", "1", arena, "5", "--trace=" + d],
                         capsys, monkeypatch)
    assert rc == 0, err
    spans = _spans(_events(d))
    assert len(spans["nbody.step"]) == 5
    frames = list(zip(spans["nbody.render"], spans["nbody.frame.copy"],
                      spans["nbody.frame.write"]))
    assert len(frames) == len(spans["nbody.frame.write"]) >= 1
    for render, copy, write in frames:
        assert render[1] <= copy[0] and copy[1] <= write[0]
        assert _inside(render, spans["nbody.step"]) == 0


def _write_trace(path, events):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid}


def test_trace_comm_share_device_kernels_and_collectives(tmp_path):
    """A trace with device events: only kernels and copies count, and the
    collectives are told by name."""
    d = str(tmp_path / "t")
    _write_trace(os.path.join(d, "a.trace.json.gz"), [
        _ev("aten::add", "cpu_op", 0, 500),
        _ev("block_forces_kernel<float, false>", "kernel", 10, 300, tid=7),
        _ev("ncclDevKernel_AllGather_RING_LL", "kernel", 400, 100, tid=7),
        _ev("Memcpy DtoH", "gpu_memcpy", 600, 50, tid=7),
        _ev("cudaLaunchKernel", "cuda_runtime", 5, 4),
        {"ph": "i", "name": "marker", "ts": 3},
    ])
    got = timing.trace_comm_share(d)
    assert got["op_us"] == 450.0 and got["collective_us"] == 100.0
    assert got["share"] == pytest.approx(100 / 450)
    assert got["by_op"] == {"ncclDevKernel_AllGather_RING_LL": 100.0}


def test_trace_comm_share_host_leaves_and_newest_file(tmp_path):
    """Without device events the leaf operators count, per thread; of two
    traces in the directory the newest is read."""
    d = str(tmp_path / "t")
    old = os.path.join(d, "old.trace.json.gz")
    _write_trace(old, [_ev("aten::mul", "cpu_op", 0, 99999)])
    os.utime(old, (1, 1))
    _write_trace(os.path.join(d, "sub", "new.trace.json.gz"), [
        _ev("aten::add", "cpu_op", 0, 100),          # parent of the next two
        _ev("aten::to", "cpu_op", 10, 20),
        _ev("c10d::allgather_", "cpu_op", 40, 30),
        _ev("aten::sqrt", "cpu_op", 100, 7),         # starts as add ends
        _ev("aten::sub", "cpu_op", 20, 50, tid=2),   # another thread
        _ev("frame", "python_function", 0, 1000),
    ])
    got = timing.trace_comm_share(d)
    assert got["op_us"] == 20 + 30 + 7 + 50
    assert got["collective_us"] == 30 and got["by_op"] == {
        "c10d::allgather_": 30.0}
    with pytest.raises(FileNotFoundError):
        timing.trace_comm_share(str(tmp_path / "empty"))


def test_cli_trace_writes_profile_and_reports_share(arena, tmp_path, capsys,
                                                    monkeypatch):
    d = str(tmp_path / "trace")
    _, plain, _ = _main(cli.main, ["32", "0", arena, "20"], capsys,
                        monkeypatch)
    rc, traced, err = _main(cli.main, ["32", "0", arena, "20", "--trace=" + d],
                            capsys, monkeypatch)
    assert rc == 0, err
    assert traced == plain
    line = [l for l in err.splitlines() if l.startswith("Trace: op time")]
    assert len(line) == 1, err
    assert line[0].endswith("collectives 0.000 s (0.00%% share) -> %s" % d)
    assert any(e.get("cat") == "cpu_op" for e in _events(d))


def test_cli_trace_unwritable_dir_does_not_kill_the_run(arena, tmp_path,
                                                        capsys, monkeypatch):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    d = str(blocker / "trace")  # a directory under a regular file
    rc, out, err = _main(cli.main, ["8", "0", arena, "3", "--trace=" + d],
                         capsys, monkeypatch)
    assert rc == 0 and len(out.splitlines()) == 8
    assert "Cannot start trace at %s" % d in err


# ---------------------------------------------------------------------------
# run_trajectory and total_energy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps, every", [(12, 1), (12, 5), (3, 4)])
def test_run_trajectory_matches_jax(steps, every):
    """fp64 trig from the glibc init: records of shape (steps // every, N),
    positions within 1e-12 relative of the JAX package's (the trig
    functions differ by an ulp), and the steps past the last record not
    run, as there."""
    n = 24
    final, xs, ys = engine.run_trajectory(CFG, init_state(n, CFG), steps,
                                          every)
    jfinal, jxs, jys = jengine.run_trajectory(JCFG, jax_init_state(n, JCFG),
                                              steps, every)
    records = steps // every
    assert xs.shape == ys.shape == (records, n) == tuple(jxs.shape)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), rtol=1e-12)
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), rtol=1e-12)
    for f in ("x", "y", "xv", "yv"):
        np.testing.assert_allclose(getattr(final, f).numpy(),
                                   np.asarray(getattr(jfinal, f)),
                                   rtol=1e-12, err_msg=f)
    same = engine.run(CFG, init_state(n, CFG), records * every)
    assert torch.equal(final.x, same.x) and torch.equal(final.y, same.y)
    if records:
        assert torch.equal(xs[-1], final.x) and torch.equal(ys[-1], final.y)


@pytest.mark.parametrize("dtype, rtol", [("float64", 1e-12),
                                         ("float32", 1e-5)])
@pytest.mark.parametrize("n", [2, 64, 300])
def test_total_energy_matches_jax(n, dtype, rtol):
    """The sums differ in order: 1e-12 relative in fp64 (1e-5 in fp32, for
    N^2/2 terms of one sign)."""
    cfg = SimConfig(force_mode="fast", dtype=dtype)
    jcfg = JaxConfig(force_mode="fast", dtype=dtype)
    st = engine.run(cfg, init_state(n, cfg), 2)
    got = engine.total_energy(cfg, st)
    want = jengine.total_energy(jcfg, _to_jax(st))
    assert got.shape == () and got.dtype == cfg.torch_dtype
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)


def test_fp32_tracks_fp64_positions():
    """tests/test_energy_drift.py's bound for the port: after 500 steps the
    fp32 fast path stays within 0.05 px of the fp64 trig path."""
    f64 = SimConfig(force_mode="trig", dtype="float64")
    f32 = SimConfig(force_mode="fast", dtype="float32")
    out64 = engine.run(f64, init_state(256, f64), 500)
    out32 = engine.run(f32, init_state(256, f32), 500)
    assert float((out32.x.double() - out64.x).abs().max()) < 0.05
    assert float((out32.y.double() - out64.y).abs().max()) < 0.05


def test_energy_bounded_fp32():
    """Friction dissipates: over 300 steps at N=256 in fp32 the energy stays
    finite and does not grow beyond round-off scale (the bound of
    tests/test_energy_drift.py's long run)."""
    cfg = SimConfig(force_mode="fast", dtype="float32")
    st = init_state(256, cfg)
    e0 = float(engine.total_energy(cfg, st))
    e1 = float(engine.total_energy(cfg, engine.run(cfg, st, 300)))
    assert np.isfinite(e1)
    assert e1 <= e0 + 0.05 * abs(e0)
