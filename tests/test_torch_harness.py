"""The port's shell harness (``bin/torch/``) on the CPU: the NP x variant
golden diffs (``tests.sh``, ``run-tests.sh``, ``failed-tests.sh``), the
experiment sweeps and ``benchmarks/speedup_tables.py`` on their CSVs, the
multi-rank smokes, and, marked slow, the 100000-step sanity check, the full
parallel sweep and the install smoke.  Every script drives
``python -m parallel_nbody_tpu_torch.cli``; runs of more than one rank are
gloo ranks on the CPU.
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIN = os.path.join(REPO, "bin", "torch")
FIXTURES = os.path.join(REPO, "tests", "fixtures")


def _run(script, *args, env=None, timeout=600):
    full = dict(os.environ, PYTHONPATH=REPO, **(env or {}))
    return subprocess.run([os.path.join(BIN, script)] + [str(a) for a in args],
                          capture_output=True, text=True, env=full,
                          cwd=REPO, timeout=timeout)


@pytest.fixture(scope="module")
def outdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tests_out_torch"))


# ---------------------------------------------------------------------------
# tests.sh: NP x variant at N=128, NP not a power of two
# ---------------------------------------------------------------------------

# trig at the fixture's 1000 steps (its oracle must equal
# tests/fixtures/128_MY_REF_OUTPUT); fast and pallas at 20 steps, which
# re-partition the same way: a run's cost is mostly its ranks' start.
STEPS = {"trig": 1000, "fast": 20, "pallas": 20}


@pytest.mark.parametrize("variant", ["trig", "fast", "pallas"])
@pytest.mark.parametrize("np_", [3, 5, 6])
def test_tests_sh_ranks_match_one_rank(np_, variant, outdir):
    r = _run("tests.sh", np_, variant, 128,
             env=dict(NBODY_PLATFORM="cpu", NBODY_TESTS_OUT=outdir,
                      STEPS=str(STEPS[variant])))
    assert r.returncode == 0, r.stderr
    base = os.path.join(outdir, "%d_%s_128_mynbody.test" % (np_, variant))
    with open(base + ".out") as f:
        out = f.read()
    assert out.endswith("STATUS=PASSED\n"), open(base + ".diff").read()
    with open(base + ".err") as f:
        assert "took" in f.read()
    ref = os.path.join(outdir, "128_%s_cpu_s%d_MY_REF_OUTPUT"
                       % (variant, STEPS[variant]))
    if variant == "trig":
        with open(ref) as a, open(os.path.join(
                FIXTURES, "128_MY_REF_OUTPUT")) as b:
            assert a.read() == b.read()


def test_failed_tests_sh_finds_a_failure(tmp_path):
    ok = tmp_path / "2_fast_16_mynbody.test.out"
    ok.write_text("state\nSTATUS=PASSED\n")
    r = _run("failed-tests.sh", env=dict(NBODY_TESTS_OUT=str(tmp_path)))
    assert r.returncode == 0 and "All tests passed." in r.stdout
    bad = tmp_path / "3_fast_16_mynbody.test.out"
    bad.write_text("state\nStatus=FAILED\n")
    r = _run("failed-tests.sh", env=dict(NBODY_TESTS_OUT=str(tmp_path)))
    assert r.returncode == 1 and str(bad) in r.stdout


def test_tests_sh_on_one_rank_needs_a_card_unless_the_cpu_is_asked(tmp_path):
    """NP=1 runs on the card unless NBODY_PLATFORM=cpu: without one the
    oracle run exits 1 and the script reports it, with nothing cached."""
    env = dict(NBODY_TESTS_OUT=str(tmp_path), STEPS="10")
    env_no_platform = {k: v for k, v in os.environ.items()
                       if k != "NBODY_PLATFORM"}
    full = dict(env_no_platform, PYTHONPATH=REPO, **env)
    r = subprocess.run([os.path.join(BIN, "tests.sh"), "1", "fast", "16"],
                       capture_output=True, text=True, env=full, cwd=REPO,
                       timeout=300)
    assert r.returncode == 3
    assert "ORACLE GENERATION FAILED" in r.stderr
    assert not [p for p in os.listdir(tmp_path) if "REF" in p]


# ---------------------------------------------------------------------------
# the experiment sweeps and the speedup tables
# ---------------------------------------------------------------------------

def test_sweeps_write_csvs_that_speedup_tables_reads(tmp_path):
    seq, par = tmp_path / "seq.csv", tmp_path / "par.csv"
    r = _run("sequential-experiments.sh",
             env=dict(NBODY_PLATFORM="cpu", REPLICATES="1", STEPS="1",
                      SIZES="512 1024", CSV=str(seq)))
    assert r.returncode == 0, r.stderr
    rows = seq.read_text().splitlines()
    assert rows[0] == "NBODIES,RTIME,GFLOPS"
    assert [row.split(",")[0] for row in rows[1:]] == ["512", "1024"]
    r = _run("experiments.sh", "--measure-comm",
             env=dict(REPLICATES="1", STEPS="2", SIZES="512", RANKS="2",
                      CSV=str(par)))
    assert r.returncode == 0, r.stderr
    rows = par.read_text().splitlines()
    assert rows[0] == ("SIZE,NODES,CPUS_PER_NODE,NBODIES,RTIME,COMMTIME,"
                       "RATIO,GFLOPS")
    assert len(rows) == 2 and rows[1].split(",")[0] == "2"
    assert rows[1].split(",")[3] == "512"
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmarks", "speedup_tables.py"),
         str(par), str(seq)], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "Speedup vs 1 shard" in r.stdout
    assert "| 512 |" in r.stdout and "N=1,024" not in r.stdout


def test_sequential_sweep_needs_a_card_unless_the_cpu_is_asked(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "NBODY_PLATFORM"}
    env.update(PYTHONPATH=REPO, REPLICATES="1", STEPS="1", SIZES="512",
               CSV=str(tmp_path / "seq.csv"))
    r = subprocess.run([os.path.join(BIN, "sequential-experiments.sh")],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=300)
    assert r.returncode == 1 and "FAILED: N=512" in r.stderr


# ---------------------------------------------------------------------------
# multi-rank smokes
# ---------------------------------------------------------------------------

def test_multihost_smoke_sh():
    r = _run("multihost-smoke.sh", 2, 2)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "MULTIHOST_OK" in r.stdout
    assert "multihost smoke: ALL 2 PROCESSES OK" in r.stdout


def test_multihost_cli_sh_matches_the_golden_fixture():
    """Two processes joined by the manual spelling (COORDINATOR_ADDRESS,
    NBODY_NUM_PROCESSES, NBODY_PROCESS_ID): rank 0 prints the reference's
    N=64, 500-step state."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    r = _run("multihost-cli.sh", 2, 64, 500, env=dict(PORT=str(port)))
    assert r.returncode == 0, r.stderr
    with open(os.path.join(FIXTURES, "seq_64_500.out")) as f:
        assert r.stdout == f.read()


# ---------------------------------------------------------------------------
# slow: the grader's sanity check, the full sweep, the install smoke
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_nbody_sanity_check():
    """N=32, 100000 steps over 2 gloo ranks against REF_OUTPUT (several
    minutes on the CPU: a collective every step)."""
    r = _run("nbody-sanity-check", timeout=3600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Output ok" in r.stdout


@pytest.mark.slow
def test_experiments_sh_full_sweep(tmp_path):
    """The full parallel sweep once: 4 sizes x 2/4/6/8 gloo ranks, 100
    steps (N=10000 on 8 ranks dominates)."""
    csv = tmp_path / "par.csv"
    r = _run("experiments.sh", env=dict(REPLICATES="1", CSV=str(csv)),
             timeout=7200)
    assert r.returncode == 0, r.stderr
    assert len(csv.read_text().splitlines()) == 1 + 4 * 4


@pytest.mark.slow
def test_install_smoke_sh(tmp_path):
    """pip-installs the package into a scratch prefix (no network: no
    build isolation, no dependencies) and runs the installed nbody-torch."""
    r = _run("install-smoke.sh", tmp_path / "prefix", timeout=1800)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "INSTALL_SMOKE_OK" in r.stdout
