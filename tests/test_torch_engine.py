"""The port's slice whole: engine.run and the CLI against the golden
fixtures (byte for byte, fp64 trig on the CPU), the kernel path against the
JAX package's Pallas engine, and the CLI's contract for flags and
devices.
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
from parallel_nbody_tpu_torch.utils import ppm
from parallel_nbody_tpu_torch.utils.output import format_state

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
    "--devices=2", "--mesh2d=1x2", "--comm=ring", "--checkpoint=c.npz",
    "--resume=c.npz", "--trace=t", "--check-nans", "--accum=compensated",
    "secsup"])
def test_unported_flags_exit_1(flag, arena, capsys, monkeypatch):
    argv = ["16", "0", arena, "3"]
    if flag == "secsup":
        argv[1] = "1"
    else:
        argv.append(flag)
    rc, out, err = _main(argv, capsys, monkeypatch)
    assert rc == 1 and out == ""
    assert "not yet ported" in err
    name = "secs_per_update" if flag == "secsup" else flag.split("=")[0]
    assert name in err


def test_bf16_kernel_not_yet_ported(arena, capsys, monkeypatch):
    rc, _, err = _main(["16", "0", arena, "3", "--pallas",
                        "--dtype=bfloat16"], capsys, monkeypatch)
    assert rc == 1 and "not yet ported" in err


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


def test_missing_ppm_exits_1(tmp_path, capsys, monkeypatch):
    rc, _, err = _main(["16", "0", str(tmp_path / "nope.ppm"), "3"], capsys,
                       monkeypatch)
    assert rc == 1 and "Cannot read" in err
