"""The port's slice whole: engine.run and the CLI against the golden
fixtures (byte for byte, fp64 trig on the CPU), the kernel path against the
JAX package's Pallas engine, and the CLI's contract for flags, devices and
launchers.  The flags that run on one device are driven in
test_torch_driver.py and test_torch_diag.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from parallel_nbody_tpu.config import SimConfig as JaxConfig
from parallel_nbody_tpu.models import engine as jengine
from parallel_nbody_tpu.state import init_state as jax_init_state
from parallel_nbody_tpu_torch import cli
from parallel_nbody_tpu_torch.config import SimConfig
from parallel_nbody_tpu_torch.models.engine import run
from parallel_nbody_tpu_torch.state import init_state
from parallel_nbody_tpu_torch.utils import checkpoint as ckpt
from parallel_nbody_tpu_torch.utils import ppm
from parallel_nbody_tpu_torch.utils.output import format_state
from torch_cases import spawned

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")


def _golden(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return f.read()


@pytest.fixture(scope="module")
def arena(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("arena") / "nbody.ppm")
    ppm.create(p, 1024, 768)
    return p


def _main(argv, capsys, monkeypatch, platform="cpu"):
    monkeypatch.setenv("NBODY_PLATFORM", platform)
    rc = cli.main(["nbody"] + argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


# ---------------------------------------------------------------------------
# golden fixtures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n, steps, name", [
    (2, 1000, "seq_2_1000.out"),
    (64, 500, "seq_64_500.out"),
    (256, 300, "seq_256_300.out"),
    (1000, 100, "seq_1000_100.out"),
    (128, 1000, "128_MY_REF_OUTPUT"),
])
def test_engine_run_matches_fixture(n, steps, name):
    cfg = SimConfig(xdim=1024, ydim=768, force_mode="trig", dtype="float64")
    assert format_state(run(cfg, init_state(n, cfg), steps)) == _golden(name)


@pytest.mark.slow
@pytest.mark.parametrize("n, steps, name", [
    (2048, 100, "seq_2048_100.out"),
    (4096, 100, "seq_4096_100.out"),
    (10000, 100, "seq_10000_100.out"),  # N = MAXBODIES; ~10 GB of pairs
    (32, 100000, "REF_OUTPUT"),
])
def test_engine_run_matches_slow_fixture(n, steps, name):
    """The four fixtures the fast tests leave out, byte for byte (fp64
    trig on the CPU)."""
    cfg = SimConfig(xdim=1024, ydim=768, force_mode="trig", dtype="float64")
    assert format_state(run(cfg, init_state(n, cfg), steps)) == _golden(name)


def test_cli_subprocess_matches_fixture(arena):
    env = dict(os.environ, NBODY_PLATFORM="cpu", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "parallel_nbody_tpu_torch.cli", "128", "0",
         arena, "1000"], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout == _golden("128_MY_REF_OUTPUT")
    assert "Running N-body with 128 bodies and 1000 steps" in r.stderr
    assert "N-body took:" in r.stderr and "GFLOPS" in r.stderr


def test_zero_steps_prints_init(arena, capsys, monkeypatch):
    rc, out, _ = _main(["4", "0", arena, "0"], capsys, monkeypatch)
    assert rc == 0
    assert out.splitlines()[0] == (
        "   313.000      9.000      0.000      0.000      4.575      2.837")


# ---------------------------------------------------------------------------
# the kernel path against the JAX package's Pallas engine
# ---------------------------------------------------------------------------

def test_kernel_path_fp32_matches_jax_pallas_run():
    """N=256, 10 steps, fp32: the port's kernel path (its plain version on
    the CPU) against JAX ``run(kernel="pallas", pallas_interpret=True)``.
    Forces agree to ~1e-7 of max|F| per step (tests/test_torch_ops.py);
    over 10 steps the state agrees to rtol 1e-5, atol 1e-3, and the forces
    to 1e-5 of their max."""
    n, steps = 256, 10
    jcfg = JaxConfig(force_mode="fast", dtype="float32", kernel="pallas",
                     pallas_interpret=True)
    want = jengine.run(jcfg, jax_init_state(n, jcfg), steps)
    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
    got = run(cfg, init_state(n, cfg), steps)
    for f in ("x", "y", "xv", "yv"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-3, err_msg=f)
    for f in ("xf", "yf"):
        w = np.asarray(getattr(want, f))
        np.testing.assert_allclose(getattr(got, f).numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=f)


def test_kernel_path_fp64_matches_dense_fast():
    """fp64, 20 steps from the glibc init at N=300 (which holds coincident
    pairs on step 1): the kernel path and the dense fast path compute the
    same pair terms, summed in another order."""
    cfg = SimConfig(force_mode="fast", dtype="float64")
    want = run(cfg, init_state(300, cfg), 20)
    got = run(cfg.replace(kernel="cuda"), init_state(300, cfg), 20)
    for f in ("x", "y", "xv", "yv", "xf", "yf"):
        w = getattr(want, f).numpy()
        np.testing.assert_allclose(getattr(got, f).numpy(), w, rtol=1e-9,
                                   atol=1e-9 * np.abs(w).max(), err_msg=f)


def test_cli_pallas_on_cpu_runs_kernel_plain_version(arena, capsys,
                                                     monkeypatch):
    rc, out, err = _main(["64", "0", arena, "20", "--pallas"], capsys,
                         monkeypatch)
    assert rc == 0, err
    cfg = SimConfig(force_mode="fast", dtype="float64", kernel="cuda")
    assert out == format_state(run(cfg, init_state(64, cfg), 20))


# ---------------------------------------------------------------------------
# CLI contract
# ---------------------------------------------------------------------------

def test_run_xps_csv(arena, capsys, monkeypatch):
    rc, out, err = _main(["32", "0", arena, "5", "--run-xps", "--fast"],
                         capsys, monkeypatch)
    assert rc == 0
    n, rtime, gflops = out.strip().split(",")
    assert n == "32" and float(rtime) >= 0 and gflops.startswith(" ")
    assert "N-body took:" in err


def test_clamp_and_atoi(arena, capsys, monkeypatch):
    rc, out, err = _main(["abc", "0", arena, "2"], capsys, monkeypatch)
    assert rc == 0 and "Using two bodies..." in err
    assert len(out.splitlines()) == 2


@pytest.mark.parametrize("flag", [
    "--devices=2", "--mesh2d=1x2", "--mesh2d=2x2", "--checkpoint=DIR",
    "--checkpoint=DIR/ck", "--resume=DIR"])
def test_unported_flags_exit_1(flag, arena, tmp_path, capsys, monkeypatch):
    """The argvs that the port refused before its distributed programs
    existed (more than one device; a directory as checkpoint or resume) now
    run: each prints the single-device run's state.  The ranks are spawned
    by the CLI in a process group of their own, under a timeout; a
    directory checkpoint holds the state after 3 steps."""
    argv = ["16", "0", arena, "3"]
    _, single, _ = _main(argv, capsys, monkeypatch)
    arg = flag.replace("DIR", str(tmp_path))
    if flag.startswith("--resume"):
        rc, _, err = _main(["16", "0", arena, "1", "--checkpoint="
                            + str(tmp_path)], capsys, monkeypatch)
        assert rc == 0, err
    if flag.startswith(("--devices", "--mesh2d")):
        rc, out, err = spawned(["-m", "parallel_nbody_tpu_torch.cli"] + argv
                               + [arg])
    else:
        rc, out, err = _main(argv + [arg], capsys, monkeypatch)
    assert rc == 0, err
    assert out == single
    assert "N-body took" in err
    if flag.startswith("--checkpoint"):
        path = arg.split("=", 1)[1]
        assert ckpt.dcp_saved_length(path) == 16
        state, step, n_real = ckpt.load_state_dcp(path, "cpu", torch.float64)
        assert (step, n_real) == (3, 16)


@pytest.mark.parametrize("flags, message", [
    (["--devices=2"], "requested a 2-device mesh but only 1 device(s) are "
                      "available (backend=cuda)"),
    (["--mesh2d=2x2"], "requested a 2x2 mesh (4 devices) but only 1 "
                       "device(s) are available")])
def test_more_ranks_than_cards_exits_1(flags, message, arena, capsys,
                                       monkeypatch):
    """NCCL takes one rank per card: on a machine with one card a mesh of
    two ranks exits 1 with the JAX package's mesh message, before any rank
    starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc, out, err = _main(["16", "0", arena, "3"] + flags, capsys,
                         monkeypatch, platform="cuda")
    assert rc == 1 and out == ""
    assert message in err and "N-body took" not in err


@pytest.mark.parametrize("env", [dict(RANK="0", WORLD_SIZE="2"),
                                 dict(COORDINATOR_ADDRESS="localhost:1",
                                      NBODY_NUM_PROCESSES="3",
                                      NBODY_PROCESS_ID="0")],
                         ids=["torchrun", "coordinator"])
def test_devices_must_match_launcher_world_size(env, arena, capsys,
                                                monkeypatch):
    """Under a launcher every rank runs the CLI: --devices must be the
    world size it set, or the CLI exits 1 before joining any group."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rc, out, err = _main(["16", "0", arena, "3", "--devices=4"], capsys,
                         monkeypatch)
    world = env.get("WORLD_SIZE") or env["NBODY_NUM_PROCESSES"]
    assert rc == 1 and out == ""
    assert ("4 devices requested, but the launcher started %s ranks"
            % world) in err


def _table(out, n):
    table = np.array([[float(v) for v in line.split()]
                      for line in out.splitlines()])
    assert table.shape == (n, 6) and np.isfinite(table).all()
    return table


@pytest.mark.parametrize("flags, cfg_kw", [
    (["--pallas", "--accum=compensated", "--dtype=float32"],
     dict(force_mode="fast", kernel="cuda", dtype="float32",
          accum="compensated")),
    (["--fast", "--accum=compensated"],
     dict(force_mode="fast", accum="compensated")),
])
def test_cli_accum_compensated_runs(flags, cfg_kw, arena, capsys,
                                    monkeypatch):
    rc, out, err = _main(["64", "0", arena, "5"] + flags, capsys,
                         monkeypatch)
    assert rc == 0, err
    _table(out, 64)
    cfg = SimConfig(**cfg_kw)
    assert out == format_state(run(cfg, init_state(64, cfg), 5))


def test_cli_bf16_pallas_runs(arena, capsys, monkeypatch):
    rc, out, err = _main(["64", "0", arena, "5", "--pallas",
                          "--dtype=bfloat16"], capsys, monkeypatch)
    assert rc == 0, err
    _table(out, 64)
    cfg = SimConfig(force_mode="fast", kernel="cuda", dtype="bfloat16")
    assert out == format_state(run(cfg, init_state(64, cfg), 5))


# ---------------------------------------------------------------------------
# accum and bf16 through the engine
# ---------------------------------------------------------------------------

def test_accum_reaches_kernel_through_engine(monkeypatch):
    """tests/test_accum.py:123-143 for the port: a spy on the dispatch that
    engine.step calls; plain and compensated agree on normal states, so
    only a spy catches a dropped argument."""
    from parallel_nbody_tpu_torch.models import engine
    seen = []
    orig = engine.cuda_forces

    def spy(cfg, *a, **kw):
        seen.append(kw.get("accum", "MISSING"))
        return orig(cfg, *a, **kw)

    monkeypatch.setattr(engine, "cuda_forces", spy)
    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="cuda",
                    accum="compensated")
    engine.step(cfg, init_state(128, cfg))
    assert seen == ["compensated"]


def test_compensated_matches_plain_on_normal_state():
    """tests/test_accum.py:87-101: glibc N=512, 3 steps, fp32, through the
    whole step: compensation changes rounding, never semantics."""
    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
    out_p = run(cfg, init_state(512, cfg), 3)
    out_c = run(cfg.replace(accum="compensated"), init_state(512, cfg), 3)
    for f in ("x", "y", "xv", "yv", "xf", "yf"):
        np.testing.assert_allclose(getattr(out_c, f).numpy(),
                                   getattr(out_p, f).numpy(), rtol=1e-5,
                                   atol=1e-4, err_msg=f)


@pytest.mark.parametrize("kernel, jax_kernel", [("dense", "xla"),
                                                ("cuda", "pallas")])
def test_bf16_run_matches_jax(kernel, jax_kernel):
    """N=64, 5 steps in bf16 from the glibc init against the JAX package's
    run (Pallas in interpret mode).  Measured on the CPU: the state is
    bit-equal on both paths; the dense path's forces differ in 20 of 64 xf
    and 21 of 64 yf (XLA fuses the bf16 pair terms at higher precision, and
    torch rounds each op), by at most 1 bf16 ulp of max|F|.  Held to 2 bf16
    ulps per element for the state and 1 ulp of max|F| for the forces."""
    n, steps = 64, 5
    jcfg = JaxConfig(force_mode="fast", dtype="bfloat16", kernel=jax_kernel,
                     pallas_interpret=True)
    want = jengine.run(jcfg, jax_init_state(n, jcfg), steps)
    cfg = SimConfig(force_mode="fast", dtype="bfloat16", kernel=kernel)
    got = run(cfg, init_state(n, cfg), steps)
    for f in ("x", "y", "xv", "yv", "xf", "yf"):
        g = getattr(got, f)
        assert g.dtype == torch.bfloat16
        g = g.float().numpy()
        w = np.asarray(getattr(want, f), np.float32)
        if f in ("xf", "yf"):
            ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
            np.testing.assert_allclose(g, w, rtol=0, atol=ulp, err_msg=f)
        else:
            # Two bf16 steps of the element's own magnitude.
            np.testing.assert_allclose(g, w, rtol=2.0 ** -6, atol=0,
                                       err_msg=f)


def test_accepted_single_device_flags(arena, capsys, monkeypatch):
    rc, out, _ = _main(["16", "0", arena, "3", "--devices=1", "--openmp",
                        "--comm=allgather", "--chunk-steps=2",
                        "--measure-comm", "--xps-precise"],
                       capsys, monkeypatch)
    assert rc == 0 and len(out.splitlines()) == 16


def test_bad_platform_exits_1(arena, capsys, monkeypatch):
    rc, out, err = _main(["16", "0", arena, "3"], capsys, monkeypatch,
                         platform="tpu")
    assert rc == 1 and out == "" and "NBODY_PLATFORM" in err


def test_cuda_requested_without_card_exits_1(arena, capsys, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc, out, err = _main(["16", "0", arena, "3", "--pallas"], capsys,
                         monkeypatch, platform="cuda")
    assert rc == 1 and out == "" and "no CUDA device" in err


def test_unset_platform_without_card_exits_1(arena, capsys, monkeypatch):
    """The device defaults to cuda: with NBODY_PLATFORM unset and no card
    the CLI refuses to run, and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("NBODY_PLATFORM", raising=False)
    rc = cli.main(["nbody", "16", "0", arena, "3", "--pallas"])
    out = capsys.readouterr()
    assert rc == 1 and out.out == "" and "no CUDA device" in out.err


def test_missing_ppm_exits_1(tmp_path, capsys, monkeypatch):
    rc, _, err = _main(["16", "0", str(tmp_path / "nope.ppm"), "3"], capsys,
                       monkeypatch)
    assert rc == 1 and "Cannot read" in err
