"""The port's accuracy tools against the JAX package's: the on-card gate
(``benchmarks/hw_validate``), the energy-drift study
(``benchmarks/drift_study``), the animation example (``examples/animate``)
and the entry points (``entry``), on the CPU at small sizes.  The JAX
package's own tools (``benchmarks/*.py``, ``examples/animate.py``) are
loaded by path; the oracles are compared on states carried across with
``utils/convert``.
"""

import functools
import importlib.util
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_nbody_tpu.config import SimConfig as JaxConfig
from parallel_nbody_tpu.models import engine as jengine
from parallel_nbody_tpu.ops.forces import forces_on_block as jax_block
from parallel_nbody_tpu.state import State as JaxState
from parallel_nbody_tpu.state import init_state as jax_init_state
from parallel_nbody_tpu_torch import entry as tentry
from parallel_nbody_tpu_torch.benchmarks import drift_study, hw_validate
from parallel_nbody_tpu_torch.examples import animate
from parallel_nbody_tpu_torch.ops import cuda_step
from parallel_nbody_tpu_torch.state import random_state
from parallel_nbody_tpu_torch.utils.convert import state_from_numpy

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX64 = JaxConfig(force_mode="fast", dtype="float64", kernel="xla")


def _load(relpath, name):
    """A JAX-side script of the repo, imported by path."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _numpy(jstate):
    return {f: np.array(v) for f, v in jstate._asdict().items()}


def _glibc64(n, pair=(10, 20)):
    """The JAX glibc init of n bodies in float64 with bodies ``pair`` made
    coincident, as numpy fields."""
    fields = _numpy(jax_init_state(n, JAX64))
    a, b = pair
    for f in ("x", "y"):
        fields[f][b] = fields[f][a]
    return fields


def _close(got, want, rel, label):
    """|got - want| <= rel * max|want| elementwise."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=label)


# ---------------------------------------------------------------------------
# hw_validate
# ---------------------------------------------------------------------------

def test_constants_and_random_specs_equal_the_jax_tools():
    """The seeded random configurations and every constant and tolerance
    of the gate and of the study are the JAX tools' (loaded by path; they
    import no JAX at module level)."""
    jhv = _load("benchmarks/hw_validate.py", "jax_hw_validate")
    assert hw_validate.random_case_specs() == jhv.random_case_specs()
    for name in ("N_SMALL", "N_LARGE", "STEPS", "ROWS_CHECKED",
                 "ORACLE_ROW_CHUNK", "RANDOM_SEED", "RANDOM_COUNT",
                 "TOL_POS", "TOL_VEL_P99", "TOL_VEL_MAX", "TOL_FORCE"):
        assert getattr(hw_validate, name) == getattr(jhv, name), name
    jds = _load("benchmarks/drift_study.py", "jax_drift_study")
    for name in ("N", "STEPS", "CHUNK", "ORACLE_ROWS", "ROW_CHUNK", "MODES"):
        assert getattr(drift_study, name) == getattr(jds, name), name
    assert drift_study.energy_at(drift_study.STEPS) == jds.ENERGY_AT


def test_oracles_match_jax_float64():
    """The float64 trajectory oracle (10 steps) and the row-chunked force
    oracle (300 of 700 rows, 128 at a time: a ragged last chunk) against
    the JAX package's float64 ``run`` and ``forces_on_block`` on the same
    state carried across, with a coincident pair: within 1e-12 of each
    field's max (both sum the same float64 terms in other orders)."""
    fields = _glibc64(300)
    want = jengine.run(JAX64, JaxState(**fields), 10)
    got = hw_validate.oracle_trajectory(
        state_from_numpy(fields, dtype=torch.float32), 10)
    # Cast up from fp32 inside the oracle: compare with the fp32 values.
    fields32 = {f: v.astype(np.float32).astype(np.float64)
                for f, v in fields.items()}
    want32 = jengine.run(JAX64, JaxState(**fields32), 10)
    for f in ("x", "y", "xv", "yv", "xf", "yf"):
        _close(getattr(got, f), getattr(want32, f), 1e-12, f)
    got64 = hw_validate.oracle_trajectory(
        state_from_numpy(fields, dtype=torch.float64), 10)
    for f in ("x", "y", "xv", "yv", "xf", "yf"):
        _close(getattr(got64, f), getattr(want, f), 1e-12, f)

    full = _glibc64(700, pair=(5, 650))
    rows = 300
    jx = [jnp.asarray(full[f]) for f in ("x", "y", "mass", "radius")]
    wx, wy = jax_block(JAX64, *(a[:rows] for a in jx), *jx,
                       same_block=False, gi0=0, gj0=0)
    tx = [torch.from_numpy(full[f]) for f in ("x", "y", "mass", "radius")]
    fx, fy = hw_validate.oracle_forces(*tx, rows, chunk=128)
    _close(fx, wx, 1e-12, "xf")
    _close(fy, wy, 1e-12, "yf")
    assert float(fx[5]) != 0.0 and np.isfinite(fx.numpy()).all()


@pytest.mark.parametrize("accum", ["plain", "compensated"])
def test_make_streamed_run_matches_jax_streamed_kernel(accum, monkeypatch):
    """The port's K2 run (its plain version on the CPU) at N=512 with band
    128 (4 bands) against the JAX tool's ``make_streamed_run`` through the
    Pallas streamed kernel in interpret mode at tile 128 (the port's
    geometry), 3 fp32 steps from a glibc init with a coincident pair (the
    biased kernel runs): forces within 2e-5 of max|F| (fp32 sums in other
    orders), positions and velocities within 1e-5 of their max."""
    from parallel_nbody_tpu.ops import pallas_step
    monkeypatch.setattr(pallas_step, "pallas_block_forces_streamed",
                        functools.partial(
                            pallas_step.pallas_block_forces_streamed,
                            interpret=True))
    jhv = _load("benchmarks/hw_validate.py", "jax_hw_validate")
    fields = {f: v.astype(np.float32) for f, v in _glibc64(512).items()}
    jcfg = JaxConfig(force_mode="fast", dtype="float32", kernel="pallas",
                     accum=accum)
    want = jhv.make_streamed_run(jcfg, 3, band=128, tile=128)(
        JaxState(**{f: jnp.asarray(v) for f, v in fields.items()}))
    got = hw_validate.make_streamed_run(hw_validate.cfg32(accum=accum), 3,
                                        128)(
        state_from_numpy(fields, dtype=torch.float32))
    assert -(-512 // cuda_step.band_width(512, 128)) == 4
    for f in ("xf", "yf"):
        _close(getattr(got, f), getattr(want, f), 2e-5, f)
    for f in ("x", "y", "xv", "yv"):
        _close(getattr(got, f), getattr(want, f), 1e-5, f)


def test_gate_passes_on_the_cpu_and_detects_the_sabotage(tmp_path, capsys):
    """The whole gate through its command line with --device=cpu, at
    ``CPU_SIZES``: every case passes at the JAX gate's tolerances, case B
    folds 4 bands, the programs are bit-equal to the fused run, and the
    gravity flip trips the velocity tolerance."""
    out = str(tmp_path / "hw_validate.json")
    rc = hw_validate.main(["hw_validate", "--device=cpu", "--out=" + out])
    text = capsys.readouterr().out
    assert rc == 0, text[-3000:]
    assert text.splitlines()[-1] == "HW_VALIDATE PASS"
    with open(out) as f:
        v = json.load(f)
    jax_keys = {"cases", "ok", "random_cases", "tolerances", "n_small",
                "n_large", "steps", "rows_checked", "backend", "device",
                "parallel_programs", "when"}
    assert jax_keys <= set(v)
    assert v["ok"] and v["bands"] == 4 and v["backend"] == "cpu"
    assert set(v["cases"]) == {"A", "B", "F", "B'", "C", "sabotage"}
    assert all(c["ok"] for k, c in v["cases"].items() if k != "sabotage")
    assert [c["n"] for c in v["random_cases"]["cases"]] == [
        s["n"] // 8 for s in hw_validate.random_case_specs()]
    assert all(p["bit_identical"] for p in v["parallel_programs"].values())
    sab = v["cases"]["sabotage"]
    assert sab["detected"] and sab["vel_max_rel"] >= hw_validate.TOL_VEL_MAX
    assert "sabotage" in text and "detected" in text


def test_gate_fails_on_a_wrong_force_pass(monkeypatch):
    """A K1 whose forces are 0.1% too large fails cases A and F (the gate
    can fail, not only its sabotage case)."""
    plain = cuda_step.block_forces_reference

    def wrong(*args, **kw):
        return tuple(f * 1.001 for f in plain(*args, **kw))

    monkeypatch.setattr(cuda_step, "block_forces_reference", wrong)
    v = hw_validate.run_gate("cpu", hw_validate.CPU_SIZES._replace(
        n_large=512, rows_checked=128), log=lambda s: None)
    assert not v["ok"]
    assert not v["cases"]["A"]["ok"] and not v["cases"]["F"]["ok"]
    assert v["cases"]["B"]["ok"]  # K2 is untouched


# ---------------------------------------------------------------------------
# drift_study
# ---------------------------------------------------------------------------

def test_energy_chunked_matches_jax_total_energy():
    """The study's row-chunked float64 energy (128 rows at a time over
    300 bodies: a ragged last chunk of 44) against the JAX package's
    ``total_energy`` on the same state, with velocities and a coincident
    pair: within 1e-12 relative."""
    fields = _glibc64(300)
    rng = np.random.RandomState(3)
    fields["xv"] = rng.uniform(-5, 5, 300)
    fields["yv"] = rng.uniform(-5, 5, 300)
    want = float(jengine.total_energy(JAX64, JaxState(**fields)))
    t = {f: torch.from_numpy(v) for f, v in fields.items()}
    got = drift_study.total_energy_chunked(
        JAX64.gravity, t["x"], t["y"], t["xv"], t["yv"], t["mass"],
        t["radius"], row_chunk=128)
    assert abs(got - want) <= 1e-12 * abs(want), (got, want)


def test_study_on_the_cpu_writes_the_jax_record_keys(tmp_path, monkeypatch,
                                                     capsys):
    """The study through its command line with --device=cpu at a small
    size: the record has every key of the JAX package's
    ``benchmarks/drift_study.json`` (modes and energies included), finite
    values, fp32 forces within the gate's TOL_FORCE of float64 and bf16's
    within 1e-2 (its inputs are rounded to 8 bits: 3.8e-3 at N=512)."""
    monkeypatch.setattr(drift_study, "CPU_SIZES",
                        drift_study.Sizes(256, 40, 20, 128))
    out = str(tmp_path / "drift.json")
    assert drift_study.main(["drift_study", "--device=cpu",
                             "--out=" + out]) == 0
    capsys.readouterr()
    with open(out) as f:
        rec = json.load(f)
    with open(os.path.join(REPO, "benchmarks", "drift_study.json")) as f:
        tpu = json.load(f)
    assert set(tpu) <= set(rec)
    assert set(rec["energy"]) == set(tpu["energy"])
    for mode, e in rec["energy"].items():
        assert set(e) == {"E0", "E20", "drift_20", "E40", "drift_40"}
        assert all(np.isfinite(v) for v in e.values()), mode
    assert set(rec["init_quantization"]) == set(tpu["init_quantization"])
    err = rec["force_operator_vs_fp64"]
    assert err["plain"]["max_rel"] < hw_validate.TOL_FORCE
    assert err["compensated"]["max_rel"] < hw_validate.TOL_FORCE
    assert err["bfloat16"]["max_rel"] < 1e-2
    assert rec["device"] == "cpu" and rec["n"] == 256


# ---------------------------------------------------------------------------
# animate
# ---------------------------------------------------------------------------

def test_animate_frames_byte_equal_to_the_jax_example(tmp_path,
                                                      monkeypatch):
    """N=64, 60 steps recorded every 20 on the CPU (fp64 in both): the same
    three PPMs as the JAX example's, byte for byte.  The port's force pass
    is K1's plain version and the JAX example's the dense XLA path; they
    sum the same fp64 terms in other orders, and no pixel's hit test lies
    within that rounding of its threshold here."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_example = _load("examples/animate.py", "jax_animate")
    monkeypatch.setattr(sys, "argv", ["animate.py", "64", "60", "20", jdir])
    assert jax_example.main() == 0
    assert animate.main(["animate", "64", "60", "20", tdir,
                         "--device=cpu"]) == 0
    names = sorted(os.listdir(jdir))
    assert names == ["frame_%04d.ppm" % i for i in range(3)]
    assert sorted(os.listdir(tdir)) == names
    for name in names:
        with open(os.path.join(jdir, name), "rb") as f:
            want = f.read()
        with open(os.path.join(tdir, name), "rb") as f:
            got = f.read()
        assert got == want, name
    assert any(want[16:])  # bodies were drawn


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_entry_step_matches_the_jax_entry():
    """``entry(device="cpu")``: fp32 random_state(4096) from a generator
    seeded 0, and one K1 step (its plain version).  On the JAX entry's
    state carried across, the step agrees with the JAX entry's step
    (dense, fp32): forces within 2e-5 of max|F| (fp32 sums in other
    orders), the rest within 1e-6 of each field's max."""
    sys.path.insert(0, REPO)
    import __graft_entry__
    fn, (state,) = tentry.entry(device="cpu")
    want_state = random_state(4096, hw_validate.cfg32(),
                              torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(state, want_state))
    assert state.x.dtype == torch.float32 and state.x.device.type == "cpu"
    jfn, (jstate,) = __graft_entry__.entry()
    want = jfn(jstate)
    got = fn(state_from_numpy(_numpy(jstate), dtype=torch.float32))
    for f in ("xf", "yf"):
        _close(getattr(got, f), getattr(want, f), 2e-5, f)
    for f in ("x", "y", "xv", "yv", "mass", "radius"):
        _close(getattr(got, f), getattr(want, f), 1e-6, f)


def test_dryrun_multichip_runs_and_raises():
    """``dryrun_multichip(2)`` runs two gloo ranks and returns; a child
    that fails (no rank to run) raises with its output."""
    tentry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="dryrun_multichip child failed"):
        tentry.dryrun_multichip(0)


# ---------------------------------------------------------------------------
# no card, no CPU asked for
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tool, argv", [
    (hw_validate.main, ["hw_validate"]),
    (drift_study.main, ["drift_study", "--out=unused.json"]),
    (animate.main, ["animate", "16", "2", "1", "unused"]),
])
def test_tools_exit_1_without_a_card(tool, argv, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool(argv) == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert "no CUDA device is available" in out.err
    assert tool(argv + ["--device=tpu"]) == 1
    assert "unsupported device" in capsys.readouterr().err


def test_entry_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()


def test_hw_validate_module_exits_1_without_a_card():
    """As a command (``python -m``), on this CPU-only host."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "parallel_nbody_tpu_torch.benchmarks"
         ".hw_validate"], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=120)
    assert r.returncode == 1 and r.stdout == ""
    assert "hw_validate: no CUDA device is available" in r.stderr
