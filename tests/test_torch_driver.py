"""The port's CLI on one device against the JAX CLI: the same argv goes
through ``parallel_nbody_tpu_torch.cli.main`` and
``parallel_nbody_tpu.cli.main`` in one process on the CPU (fp64, so stdout
is compared byte for byte), plus the ``.npz`` checkpoint layout, resume in
both directions across the packages, frames, the frame log and the cadence.
"""

import os
import re

import numpy as np
import pytest
import torch

import parallel_nbody_tpu.cli as jcli
import parallel_nbody_tpu.utils.checkpoint as jckpt
from parallel_nbody_tpu.config import SimConfig as JaxConfig
from parallel_nbody_tpu_torch import cli
from parallel_nbody_tpu_torch.config import SimConfig
from parallel_nbody_tpu_torch.models.engine import run
from parallel_nbody_tpu_torch.state import State, init_state
from parallel_nbody_tpu_torch.utils import checkpoint as ckpt
from parallel_nbody_tpu_torch.utils import ppm
from parallel_nbody_tpu_torch.utils.output import format_state

torch.set_num_threads(1)

CFG = SimConfig(force_mode="trig", dtype="float64")
# The JAX CLI shards over every device it sees (8 virtual ones under
# tests/conftest.py); --devices=1 makes it the single-device run the port is.
ONE = ["--devices=1"]


@pytest.fixture(scope="module")
def arena(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("arena") / "nbody.ppm")
    ppm.create(p, 1024, 768)
    return p


@pytest.fixture
def small_arena(tmp_path):
    p = str(tmp_path / "small.ppm")
    ppm.create(p, 256, 192)
    return p


def _run(main, argv, capsys, monkeypatch, env=None):
    """(rc, stdout, stderr) of one in-process CLI run on the CPU."""
    monkeypatch.setenv("NBODY_PLATFORM", "cpu")
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    capsys.readouterr()
    rc = main(["nbody"] + argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _port(argv, capsys, monkeypatch, env=None):
    return _run(cli.main, argv, capsys, monkeypatch, env)


def _jax(argv, capsys, monkeypatch, env=None):
    return _run(jcli.main, argv, capsys, monkeypatch, env)


def _stderr_tail(err):
    """The two timing lines, their digits masked."""
    lines = [l for l in err.splitlines() if l.startswith(
        ("N-body took:", "Performance N-body:"))]
    return [re.sub(r"[0-9.]+", "T", l) for l in lines]


# ---------------------------------------------------------------------------
# the two faults: negative steps, single-device spellings
# ---------------------------------------------------------------------------

def test_negative_steps_zero_gflops_as_jax(arena, capsys, monkeypatch):
    argv = ["4", "0", arena, "-5", "--run-xps"]
    rc, out, err = _port(argv, capsys, monkeypatch)
    jrc, jout, jerr = _jax(argv + ONE, capsys, monkeypatch)
    assert rc == jrc == 0
    assert re.fullmatch(r"4,\d+\.\d{3}, 0\.00\n", out), out
    assert re.fullmatch(r"4,\d+\.\d{3}, 0\.00\n", jout), jout
    assert "Performance N-body: 0.00 GFLOPS" in err
    assert "Performance N-body: 0.00 GFLOPS" in jerr
    assert "Running N-body with 4 bodies and -5 steps" in err


def test_negative_steps_print_the_initial_state(arena, capsys, monkeypatch):
    rc, out, _ = _port(["4", "0", arena, "-5"], capsys, monkeypatch)
    jrc, jout, _ = _jax(["4", "0", arena, "-5"] + ONE, capsys, monkeypatch)
    assert rc == jrc == 0 and out == jout
    assert out == format_state(init_state(4, CFG))


@pytest.mark.parametrize("flags, jflags", [
    (["--comm=ring", "--devices=1"], ["--comm=ring", "--devices=1"]),
    (["--comm=ring"], ["--comm=ring", "--devices=1"]),
    (["--mesh2d=1x1"], ["--mesh2d=1x1"]),
    (["--mesh2d=1x1", "--devices=1"], ["--mesh2d=1x1", "--devices=1"]),
    (["--mesh2d=1X1", "--comm=ring"], ["--mesh2d=1X1", "--comm=ring"]),
])
def test_single_device_spellings_run_as_jax(flags, jflags, arena, capsys,
                                            monkeypatch):
    argv = ["16", "0", arena, "7"]
    rc, out, err = _port(argv + flags, capsys, monkeypatch)
    jrc, jout, jerr = _jax(argv + jflags, capsys, monkeypatch)
    assert rc == jrc == 0, err
    assert out == jout and len(out.splitlines()) == 16
    note = ("Note: --mesh2d=1x1 is a single-device run (no 2-D "
            "decomposition)\n")
    assert (note in err) == (note in jerr) == any(
        f.startswith("--mesh2d") for f in flags)
    assert _stderr_tail(err) == _stderr_tail(jerr) == [
        "N-body took: T seconds", "Performance N-body: T GFLOPS"]


def test_mesh2d_devices_conflict_exits_1_as_jax(arena, capsys, monkeypatch):
    argv = ["16", "0", arena, "3", "--mesh2d=1x1", "--devices=2"]
    rc, out, err = _port(argv, capsys, monkeypatch)
    jrc, jout, jerr = _jax(argv, capsys, monkeypatch)
    assert rc == jrc == 1 and out == jout == ""
    line = "--mesh2d=1x1 implies 1 devices; conflicting --devices=2\n"
    assert line in err and line in jerr


# ---------------------------------------------------------------------------
# .npz layout and round trip
# ---------------------------------------------------------------------------

def test_save_load_round_trip(tmp_path):
    st = run(CFG, init_state(16, CFG), 50)
    path = str(tmp_path / "s.npz")
    ckpt.save_state(path, st, 50)
    loaded, step = ckpt.load_state(path, "cpu", torch.float64)
    assert step == 50
    for a, b in zip(st, loaded):
        assert torch.equal(a, b)


def test_npz_layout_is_the_jax_package_s(tmp_path):
    """Same member names, dtypes and bytes as the JAX package's save of the
    same state, and each package loads the other's file."""
    st = run(CFG, init_state(16, CFG), 5)
    mine, theirs = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    ckpt.save_state(mine, st, 5)
    jcfg = JaxConfig(force_mode="trig", dtype="float64")
    import jax.numpy as jnp
    from parallel_nbody_tpu.state import State as JState
    jst = JState(*(jnp.asarray(t.numpy()) for t in st))
    jckpt.save_state(theirs, jst, 5)
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files) == sorted(
            State._fields + ("step",))
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k
        assert a["step"].dtype == np.int64 and a["x"].dtype == np.float64
    from_jax, step = ckpt.load_state(theirs, "cpu", torch.float64)
    to_jax, jstep = jckpt.load_state(mine, jcfg)
    assert step == jstep == 5
    for f in State._fields:
        assert torch.equal(getattr(from_jax, f), getattr(st, f))
        np.testing.assert_array_equal(np.asarray(getattr(to_jax, f)),
                                      getattr(st, f).numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_load_state_casts_to_the_run_dtype(dtype, tmp_path):
    st = init_state(8, CFG)
    path = str(tmp_path / "s.npz")
    ckpt.save_state(path, st, 3)
    loaded, _ = ckpt.load_state(path, "cpu", dtype)
    for a, b in zip(st, loaded):
        assert b.dtype == dtype and torch.equal(a.to(dtype), b)
    # A narrow state is stored as float64 too, exactly.
    ckpt.save_state(path, loaded, 4)
    with np.load(path) as z:
        assert z["mass"].dtype == np.float64
        np.testing.assert_array_equal(z["mass"],
                                      loaded.mass.double().numpy())


def test_resume_is_bit_exact(tmp_path):
    full = run(CFG, init_state(16, CFG), 100)
    half = run(CFG, init_state(16, CFG), 40)
    path = str(tmp_path / "h.npz")
    ckpt.save_state(path, half, 40)
    resumed, step = ckpt.load_state(path, "cpu", torch.float64)
    assert format_state(run(CFG, resumed, 100 - step)) == format_state(full)


# ---------------------------------------------------------------------------
# checkpoint and resume through the CLI, within and across the packages
# ---------------------------------------------------------------------------

def test_cli_checkpoint_resume_bitexact(arena, tmp_path, capsys, monkeypatch):
    ck = str(tmp_path / "state.npz")
    _, full, _ = _port(["16", "0", arena, "200"], capsys, monkeypatch)
    rc, first, err = _port(["16", "0", arena, "100", "--checkpoint=" + ck],
                           capsys, monkeypatch)
    assert rc == 0 and os.path.exists(ck), err
    rc, second, err = _port(["16", "0", arena, "200", "--resume=" + ck],
                            capsys, monkeypatch)
    assert rc == 0, err
    assert second == full and second != first


@pytest.mark.parametrize("saver, resumer", [("jax", "port"), ("port", "jax")])
def test_cross_package_resume_byte_equal(saver, resumer, arena, tmp_path,
                                         capsys, monkeypatch):
    """One CLI checkpoints at step 5, the other resumes to step 10: stdout
    is byte-equal to each package's uninterrupted 10-step run."""
    mains = {"jax": (jcli.main, ONE), "port": (cli.main, [])}
    ck = str(tmp_path / "five.npz")
    argv = ["24", "0", arena]
    _, port_full, _ = _port(argv + ["10"], capsys, monkeypatch)
    _, jax_full, _ = _jax(argv + ["10"] + ONE, capsys, monkeypatch)
    assert port_full == jax_full and len(port_full.splitlines()) == 24
    main, extra = mains[saver]
    rc, five, err = _run(main, argv + ["5", "--checkpoint=" + ck] + extra,
                         capsys, monkeypatch)
    assert rc == 0 and os.path.exists(ck), err
    main, extra = mains[resumer]
    rc, ten, err = _run(main, argv + ["10", "--resume=" + ck] + extra,
                        capsys, monkeypatch)
    assert rc == 0, err
    assert ten == port_full and ten != five


def test_resume_past_target_records_the_true_step(tmp_path, capsys,
                                                  monkeypatch):
    """Resuming a step-100 checkpoint with argv steps=50 runs zero steps;
    the re-saved checkpoint records step 100, not argv's 50."""
    arena = str(tmp_path / "arena.ppm")
    ppm.create(arena, 64, 48)
    ck1, ck2 = str(tmp_path / "ck1.npz"), str(tmp_path / "ck2.npz")
    rc, out1, _ = _port(["4", "0", arena, "100", "--checkpoint=" + ck1],
                        capsys, monkeypatch)
    assert rc == 0
    rc, out2, err = _port(["4", "0", arena, "50", "--resume=" + ck1,
                           "--checkpoint=" + ck2, "--run-xps"], capsys,
                          monkeypatch)
    assert rc == 0, err
    assert re.fullmatch(r"4,\d+\.\d{3}, 0\.00\n", out2), out2
    st1, step1 = ckpt.load_state(ck1, "cpu", torch.float64)
    st2, step2 = ckpt.load_state(ck2, "cpu", torch.float64)
    assert step1 == 100
    assert step2 == 100  # NOT argv's 50
    for a, b in zip(st1, st2):
        assert torch.equal(a, b)
    # The JAX CLI reads the same step from the port's file.
    assert jckpt.load_state(ck2, JaxConfig(xdim=64, ydim=48))[1] == 100


def test_resume_missing_path_fails_loudly(arena, capsys, monkeypatch):
    argv = ["16", "0", arena, "10", "--resume=/nonexistent/ck.npz"]
    rc, out, err = _port(argv, capsys, monkeypatch)
    jrc, _, jerr = _jax(argv + ONE, capsys, monkeypatch)
    assert rc == jrc == 1 and out == ""
    assert "Cannot resume from /nonexistent/ck.npz" in err
    assert "Cannot resume from /nonexistent/ck.npz" in jerr


@pytest.mark.parametrize("damage", ["truncated", "garbage", "missing_field",
                                    "not_a_zip"])
def test_resume_damaged_npz_fails_loudly(damage, arena, tmp_path, capsys,
                                         monkeypatch):
    """numpy raises EOFError / BadZipFile / KeyError / ValueError for these,
    none of them an OSError: the resume guard names the file and exits 1, in
    both packages."""
    ck = tmp_path / "ck.npz"
    rc, _, err = _port(["16", "0", arena, "5", "--checkpoint=%s" % ck],
                       capsys, monkeypatch)
    assert rc == 0, err
    bad = tmp_path / ("%s.npz" % damage)
    if damage == "truncated":
        bad.write_bytes(ck.read_bytes()[:40])
    elif damage == "garbage":
        bad.write_bytes(b"PK\x03\x04 not actually a zip archive")
    elif damage == "missing_field":
        with np.load(ck) as z:
            np.savez(bad, **{k: z[k] for k in z.files if k != "yv"})
    else:
        bad.write_bytes(b"\x00" * 64)
    argv = ["16", "0", arena, "5", "--resume=%s" % bad]
    rc, out, err = _port(argv, capsys, monkeypatch)
    jrc, _, jerr = _jax(argv + ONE, capsys, monkeypatch)
    assert rc == jrc == 1 and out == ""
    assert "Cannot resume from %s" % bad in err
    assert "Cannot resume from %s" % bad in jerr


def test_resume_wrong_body_count(arena, tmp_path, capsys, monkeypatch):
    ck = str(tmp_path / "ck.npz")
    assert _port(["16", "0", arena, "5", "--checkpoint=" + ck], capsys,
                 monkeypatch)[0] == 0
    argv = ["12", "0", arena, "9", "--resume=" + ck]
    rc, out, err = _port(argv, capsys, monkeypatch)
    jrc, _, jerr = _jax(argv + ONE, capsys, monkeypatch)
    assert rc == jrc == 1 and out == ""
    assert "Checkpoint has 16 bodies, expected 12\n" in err
    assert "Checkpoint has 16 bodies, expected 12\n" in jerr


def test_checkpoint_into_missing_directory_is_guarded(arena, tmp_path, capsys,
                                                      monkeypatch):
    """The failed save is reported and the run's output still delivered."""
    ck = str(tmp_path / "no" / "parent.npz")
    rc, out, err = _port(["4", "0", arena, "1", "--checkpoint=" + ck],
                         capsys, monkeypatch)
    assert rc == 0
    assert "Cannot checkpoint to %s" % ck in err
    assert len(out.splitlines()) == 4 and "N-body took:" in err


def test_checkpoint_guard_catches_only_oserror(arena, tmp_path, capsys,
                                               monkeypatch):
    """The JAX CLI's .npz save guard catches OSError and nothing else; the
    port matches it, so another failure of the save surfaces in both."""
    def boom(*a, **kw):
        raise ValueError("not an OSError")

    ck = "--checkpoint=" + str(tmp_path / "c.npz")
    monkeypatch.setattr(ckpt, "save_state", boom)
    monkeypatch.setattr(jckpt, "save_state", boom)
    monkeypatch.setenv("NBODY_PLATFORM", "cpu")
    with pytest.raises(ValueError, match="not an OSError"):
        cli.main(["nbody", "4", "0", arena, "1", ck])
    with pytest.raises(ValueError, match="not an OSError"):
        jcli.main(["nbody", "4", "0", arena, "1", ck] + ONE)


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

def test_frame_rendering_with_secsup(small_arena, capsys, monkeypatch):
    rc, out, err = _port(["8", "1", small_arena, "3000"], capsys, monkeypatch)
    assert rc == 0, err
    px = ppm.read_pixels(ppm.read_header(small_arena))
    assert px.any(), "expected at least one rendered frame with bodies"
    # Frames do not move the state.
    _, plain, _ = _port(["8", "0", small_arena, "3000"], capsys, monkeypatch)
    assert out == plain


def _frame_log(path):
    with open(path) as f:
        lines = f.read().splitlines()
    for line in lines:
        assert re.fullmatch(
            r"frame \d+\.\d{3} nonzero=\d+ tints=\d+ md5=[0-9a-f]{32}", line), \
            line
    return lines


def test_frame_log_line_equals_jax_on_the_same_state(tmp_path, capsys,
                                                     monkeypatch):
    """Zero steps past a checkpoint never render, so run one chunk of one
    step from the same file in both CLIs: each draws its one frame from the
    same fp64 state, and the lines agree but for the time stamp."""
    logs = {}
    for name, main, extra in (("port", cli.main, []),
                              ("jax", jcli.main, ONE)):
        arena = str(tmp_path / (name + ".ppm"))
        ppm.create(arena, 256, 192)
        logs[name] = str(tmp_path / (name + ".log"))
        rc, _, err = _run(main, ["40", "1", arena, "1"] + extra, capsys,
                          monkeypatch, env={"NBODY_FRAME_LOG": logs[name]})
        assert rc == 0, err
    mine, theirs = _frame_log(logs["port"]), _frame_log(logs["jax"])
    assert len(mine) == len(theirs) == 1
    assert mine[0].split()[2:] == theirs[0].split()[2:]
    with open(str(tmp_path / "port.ppm"), "rb") as a, \
            open(str(tmp_path / "jax.ppm"), "rb") as b:
        assert a.read() == b.read()


def test_frame_log_md5_is_the_frame_s(small_arena, tmp_path, capsys,
                                      monkeypatch):
    import hashlib
    log = str(tmp_path / "frames.log")
    rc, _, err = _port(["8", "1", small_arena, "1"], capsys, monkeypatch,
                       env={"NBODY_FRAME_LOG": log})
    assert rc == 0, err
    (line,) = _frame_log(log)
    px = ppm.read_pixels(ppm.read_header(small_arena)).reshape(-1, 3)
    fields = dict(f.split("=") for f in line.split()[2:])
    assert fields["md5"] == hashlib.md5(px.tobytes()).hexdigest()
    lit = px[(px != 0).any(axis=1)]
    assert int(fields["nonzero"]) == lit.shape[0] > 0
    assert int(fields["tints"]) == np.unique(lit, axis=0).shape[0]


@pytest.mark.parametrize("flags", [["--chunk-steps=7"],
                                   ["--chunk-steps=1000"]])
def test_chunk_steps_matches_single_dispatch(flags, arena, capsys,
                                             monkeypatch):
    _, a, _ = _port(["32", "0", arena, "100"], capsys, monkeypatch)
    rc, b, err = _port(["32", "0", arena, "100"] + flags, capsys, monkeypatch)
    assert rc == 0, err
    assert a == b


def test_chunk_steps_caps_the_frame_chunk(small_arena, capsys, monkeypatch):
    """With frames, --chunk-steps=K bounds the steps between two looks at
    the clock: a spy on engine.run sees no chunk above K, and the state is
    the unchunked one."""
    from parallel_nbody_tpu_torch.models import engine
    seen = []
    orig = engine.run

    def spy(cfg, state, steps, *a, **kw):
        seen.append(steps)
        return orig(cfg, state, steps, *a, **kw)

    monkeypatch.setattr(engine, "run", spy)
    rc, out, err = _port(["8", "1", small_arena, "100", "--chunk-steps=3"],
                         capsys, monkeypatch)
    assert rc == 0, err
    assert sum(seen) == 100 and max(seen) <= 3 and len(seen) >= 34
    monkeypatch.setattr(engine, "run", orig)
    _, plain, _ = _port(["8", "0", small_arena, "100"], capsys, monkeypatch)
    assert out == plain


@pytest.mark.parametrize("secsup, per_step, want", [
    # Steps slower than secsup: check every step, like the reference.
    (1, 2.0, 1), (1, 1.0, 1),
    # 10 steps/sec at secsup=1 -> largest power of two <= 10.
    (1, 0.1, 8), (5, 0.001, 4096),
])
def test_cadence_chunk_cap_unit(secsup, per_step, want):
    assert cli.cadence_chunk_cap(secsup, per_step) == want
    assert jcli.cadence_chunk_cap(secsup, per_step) == want


def test_cadence_chunk_cap_degenerate_probe():
    # Degenerate probe readings never produce a non-positive chunk.
    assert cli.cadence_chunk_cap(1, 0.0) >= 1
    assert cli.cadence_chunk_cap(1, 0.0) == jcli.cadence_chunk_cap(1, 0.0)


def test_frame_cadence_with_slow_steps(small_arena, tmp_path, capsys,
                                       monkeypatch):
    """With secsup=1 at a slow-stepping N, frames keep coming at least about
    every 2*secsup of wall time (tests/test_cli.py's case, same guard): an
    uncapped chunk would space the elapsed checks much wider than secsup."""
    log = str(tmp_path / "frames.log")
    rc, _, err = _port(["1500", "1", small_arena, "40"], capsys, monkeypatch,
                       env={"NBODY_FRAME_LOG": log})
    assert rc == 0, err
    rtime = float(re.search(r"N-body took: ([0-9.]+)", err).group(1))
    frames = len(_frame_log(log))
    assert frames >= 1
    if rtime >= 6.0:  # guard: on an implausibly fast box the run is too
        # short to discriminate; the unit test above still covers the cap.
        assert frames >= int(rtime / 2.0) - 1, (frames, rtime)
