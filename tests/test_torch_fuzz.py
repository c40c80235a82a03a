"""The port's fuzz and render-parity harness (``bin/torch/fuzz-*.sh``,
``bin/torch/render-parity.sh``) against the reference binary's committed
outputs.

The JAX repo's sweeps cached every output of the reference binary that they
diffed against (``tests_out/fuzz*/seq_<N>_<STEPS>.out``) and its frames
(``tests_out/render_parity/ref_*``); the port's scripts read those caches
and never write there.  The port's records of the full replay, made with
the recorded seeds of ``tests/test_fuzz.py``, are ``tests_out/torch_fuzz*``
and ``tests_out/torch_render_parity``.  Here: the records map one to one
onto the generator streams and equal the oracle's bytes; a live sample of
two recorded streams through the scripts on the CPU; the scripts' failure
modes.  Marked slow: the full replay (all 166 configs, ~30 min on 8 cores)
and render-parity's three variants at N=10000 (~10 GB, ~2 min).
"""

import filecmp
import hashlib
import os
import shutil
import socket
import subprocess
import sys

import pytest

from test_fuzz import (PARITY2_SWEEPS, PARITY_SWEEPS, RESUME2_SWEEPS,
                       RESUME_SWEEPS)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIN = os.path.join(REPO, "bin", "torch")
OUT = os.path.join(REPO, "tests_out")

# stream kind -> (script, recorded (seed, count) sweeps, JAX record
# directory, the port's record directory).
STREAMS = {
    "parity": ("fuzz-parity.sh", PARITY_SWEEPS, "fuzz", "torch_fuzz"),
    "parity2": ("fuzz-parity-v2.sh", PARITY2_SWEEPS, "fuzz_v2",
                "torch_fuzz_v2"),
    "resume": ("fuzz-resume.sh", RESUME_SWEEPS, "fuzz_resume",
               "torch_fuzz_resume"),
    "resume2": ("fuzz-resume-v2.sh", RESUME2_SWEEPS, "fuzz_resume_v2",
                "torch_fuzz_resume_v2"),
}
RENDER_TAGS = ("s3", "s3__devices_4", "s3__mesh2d_2x4")


def _gen(kind, seed, count):
    out = subprocess.check_output(
        [sys.executable, os.path.join(REPO, "bin", "fuzz_gen.py"), kind,
         str(seed), str(count)], text=True)
    return [line.split() for line in out.splitlines()]


def _mangle(s):
    # The scripts' `tr ' =' '__'`, after the resume loop's '|' -> ' '.
    return s.replace("|", " ").replace(" ", "_").replace("=", "_")


def _expected(kind, sweeps):
    """{record base name: [(suffix, oracle file name)]} of a stream."""
    bases = {}
    for seed, count in sweeps:
        for cfg in _gen(kind, seed, count):
            if kind == "parity":
                n, steps, *flags = cfg
                base = "fuzz_%s_%s_%s" % (n, steps, _mangle(" ".join(flags)))
                bases[base] = [("", "seq_%s_%s.out" % (n, steps))]
            elif kind == "parity2":
                n, steps, procs, *flags = cfg
                base = "fuzz_%s_%s_p%s_%s" % (n, steps, procs,
                                              _mangle(" ".join(flags)))
                bases[base] = [("", "seq_%s_%s.out" % (n, steps))]
            else:
                n, total, split, fmt, f1, f2 = cfg
                base = "resume_%s_%sof%s_%s_%s_%s" % (
                    n, split, total, fmt, _mangle(f1), _mangle(f2))
                bases[base] = [(".leg1", "seq_%s_%s.out" % (n, split)),
                               ("", "seq_%s_%s.out" % (n, total))]
    return bases


def _read(path):
    with open(path) as f:
        return f.read()


def _check_records(kind, sweeps, oracle_dir, record_dir, strict=True):
    """Every config's record passed: its .diff files are empty, its .out
    is the oracle's bytes followed by STATUS=PASSED, and a resume's
    .leg1.out is leg 1's oracle's bytes.  ``strict``: the directory holds
    these records and nothing else (the harness's arena copy aside)."""
    bases = _expected(kind, sweeps)
    want = {base + leg + ext for base, legs in bases.items()
            for leg, _ in legs for ext in (".out", ".err", ".diff")}
    got = set(os.listdir(record_dir)) - {"arena.ppm"}
    if strict:
        assert got == want, (sorted(got - want), sorted(want - got))
    for base, legs in bases.items():
        for leg, oracle in legs:
            path = os.path.join(record_dir, base + leg)
            assert os.path.getsize(path + ".diff") == 0, path
            status = "" if leg else "STATUS=PASSED\n"
            assert _read(path + ".out") == _read(
                os.path.join(oracle_dir, oracle)) + status, path
    return len(bases)


@pytest.mark.parametrize("kind", sorted(STREAMS))
def test_port_records_map_onto_generator_streams(kind):
    """The committed replay of the recorded seeds: parity 85, parity2 36,
    resume 25 and resume2 20 configs, every one passed, no file beside
    them (no copy of an oracle either: every one was cached)."""
    _, sweeps, jax_dir, port_dir = STREAMS[kind]
    n = _check_records(kind, sweeps, os.path.join(OUT, jax_dir),
                       os.path.join(OUT, port_dir))
    assert n == sum(count for _, count in sweeps)


@pytest.mark.parametrize("tag", RENDER_TAGS)
def test_port_render_parity_records(tag):
    """The committed render-parity records: the port's frame equals the
    reference binary's own frame byte for byte, its printout the
    reference's, and the frame log shows a frame drawn at each of the 3
    steps (the premise that the file holds the final state's frame)."""
    ours = os.path.join(OUT, "torch_render_parity")
    ref = os.path.join(OUT, "render_parity")
    assert _read(os.path.join(ours, "STATUS_" + tag)) == "STATUS=PASSED\n"
    assert filecmp.cmp(os.path.join(ours, "ours_%s.ppm" % tag),
                       os.path.join(ref, "ref_%s.ppm" % tag), shallow=False)
    assert _read(os.path.join(ours, "ours_%s.out" % tag)) == _read(
        os.path.join(ref, "ref_%s.out" % tag))
    assert os.path.getsize(os.path.join(ours, "stdout_%s.diff" % tag)) == 0
    frames = _read(os.path.join(ours, "frames_%s.log" % tag)).splitlines()
    assert len(frames) == 3 and all(f.startswith("frame ") for f in frames)
    assert set(os.listdir(ours)) == {
        name % t for t in RENDER_TAGS for name in (
            "STATUS_%s", "ours_%s.ppm", "ours_%s.out", "ours_%s.err",
            "frames_%s.log", "stdout_%s.diff")}


# ---------------------------------------------------------------------------
# the scripts, live, on the CPU
# ---------------------------------------------------------------------------

def _snapshot():
    """{path: digest} of every file of the JAX repo's records that the
    port's scripts read."""
    snap = {}
    for d in ("fuzz", "fuzz_v2", "fuzz_resume", "fuzz_resume_v2",
              "render_parity"):
        for f in sorted(os.listdir(os.path.join(OUT, d))):
            with open(os.path.join(OUT, d, f), "rb") as fh:
                snap[d, f] = hashlib.sha256(fh.read()).hexdigest()
    return snap


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(script, *args, env=None, timeout=600):
    full = dict(os.environ, PYTHONPATH=REPO, **(env or {}))
    return subprocess.run(["bash", os.path.join(BIN, script)]
                          + [str(a) for a in args], capture_output=True,
                          text=True, env=full, cwd=REPO, timeout=timeout)


def _hermetic(tmp_path, **env):
    """No reference binary, and results in tmp_path/out."""
    return dict(NBODY_REF_BIN=str(tmp_path / "no-binary"),
                NBODY_FUZZ_OUT=str(tmp_path / "out"), **env)


# Prefixes of recorded streams, so every oracle is cached: parity2's first
# config of seed 20260818 is a PROCS=2 run of --pallas through
# multihost-cli.sh, its first 2 of seed 9090 --fast on 6 ranks and --pallas
# on an 8-rank ring; resume2's first 2 of seed 2468 a directory checkpoint
# from 3 ranks resumed on a 1x8 grid and a .npz from --fast on a 4x2 grid
# resumed under --pallas on 8 ranks.
@pytest.mark.parametrize("kind, count, seed", [("parity2", 1, 20260818),
                                               ("parity2", 2, 9090),
                                               ("resume2", 2, 2468)])
def test_live_sample_of_a_recorded_stream(kind, count, seed, tmp_path):
    script, _, jax_dir, port_dir = STREAMS[kind]
    before = _snapshot()
    r = _run(script, count, seed,
             env=_hermetic(tmp_path, NBODY_FUZZ_PORT=str(_free_port() - 1)))
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("PASSED") == count, r.stdout
    out = str(tmp_path / "out")
    _check_records(kind, [(seed, count)], os.path.join(OUT, jax_dir), out)
    assert not [f for f in os.listdir(out) if f.startswith("seq_")]
    # The same bytes as the committed replay's records.
    for f in os.listdir(out):
        if f.endswith(".out"):
            assert _read(os.path.join(out, f)) == _read(
                os.path.join(OUT, port_dir, f)), f
    assert _snapshot() == before


@pytest.mark.parametrize("kind, count", [("parity", 3), ("resume", 2)])
def test_unrecorded_seed_skips_without_the_binary(kind, count, tmp_path):
    """No reduced set in silence: with an oracle uncached and no binary the
    script runs nothing, says how many it lacks, and exits 0."""
    script, _, jax_dir, _ = STREAMS[kind]
    seed = 123456789
    need = {(c[0], c[1]) for c in _gen(kind, seed, count)}
    if kind == "resume":
        need = {(c[0], k) for c in _gen(kind, seed, count)
                for k in (c[1], c[2])}
    missing = [p for p in need if not os.path.exists(
        os.path.join(OUT, jax_dir, "seq_%s_%s.out" % p))]
    assert missing
    r = _run(script, count, seed, env=_hermetic(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout == ("SKIPPED: reference binary not found at %s (%d of "
                        "%d oracles uncached)\n" % (tmp_path / "no-binary",
                                                    len(missing), len(need)))
    assert os.listdir(tmp_path / "out") == []


@pytest.mark.parametrize("script, args", [
    ("fuzz-parity.sh", (3, 123456789)), ("fuzz-resume-v2.sh", (2, 123456789)),
    ("render-parity.sh", ())])
def test_no_reference_binary_unless_named(script, args, tmp_path,
                                          monkeypatch):
    """NBODY_REF_BIN has no default: unset, an uncached oracle is missing
    and the script skips, running no binary from around the checkout."""
    monkeypatch.delenv("NBODY_REF_BIN", raising=False)
    r = _run(script, *args, env=dict(
        NBODY_FUZZ_OUT=str(tmp_path / "out"),
        NBODY_RENDER_ORACLE=str(tmp_path / "empty"),
        NBODY_RENDER_OUT=str(tmp_path / "out")))
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("SKIPPED: reference binary not found at "
                               "(NBODY_REF_BIN unset) ("), r.stdout
    assert os.listdir(tmp_path / "out") == []


def test_broken_seed_fails_loudly(tmp_path):
    r = _run("fuzz-parity.sh", 1, "notanumber", env=_hermetic(tmp_path))
    assert r.returncode == 1, r.stdout + r.stderr
    assert "CONFIG GENERATION FAILED" in r.stdout


def test_changed_oracle_byte_fails(tmp_path):
    """One byte changed in a copy of the oracle directory: the config that
    reads it FAILS, with its diff, and the script exits 1."""
    oracle = tmp_path / "oracle"
    shutil.copytree(os.path.join(OUT, "fuzz"), oracle)
    (n, steps, *flags), = _gen("parity", 2026, 1)
    path = oracle / ("seq_%s_%s.out" % (n, steps))
    text = path.read_text()
    path.write_text(text.replace("0", "1", 1))
    r = _run("fuzz-parity.sh", 1, 2026,
             env=_hermetic(tmp_path, NBODY_FUZZ_ORACLE=str(oracle)))
    assert r.returncode == 1, r.stdout + r.stderr
    assert r.stdout.startswith("FAILED N=%s steps=%s" % (n, steps))
    base = tmp_path / "out" / ("fuzz_%s_%s_%s" % (n, steps,
                                                  _mangle(" ".join(flags))))
    assert (base.parent / (base.name + ".out")).read_text().endswith(
        "Status=FAILED\n")
    assert (base.parent / (base.name + ".diff")).stat().st_size > 0


def test_refuses_to_write_into_the_oracle_directory(tmp_path):
    r = _run("fuzz-parity.sh", 1, 2026,
             env=dict(NBODY_FUZZ_OUT=os.path.join(OUT, "fuzz")))
    assert r.returncode == 2, r.stdout + r.stderr
    assert r.stdout.startswith("REFUSED")


def test_fuzz_ranks():
    r = subprocess.run(
        ["bash", "-c", ". %s/common.sh; fuzz_ranks --devices=3; "
         "fuzz_ranks --fast --mesh2d=2x4; fuzz_ranks --pallas; "
         "fuzz_ranks --devices=8 --comm=ring" % BIN],
        capture_output=True, text=True, timeout=60)
    assert r.stdout.split() == ["3", "8", "1", "8"], r.stderr


def test_render_parity_skips_and_refuses(tmp_path):
    env = dict(NBODY_REF_BIN=str(tmp_path / "no-binary"),
               NBODY_RENDER_ORACLE=str(tmp_path / "empty"),
               NBODY_RENDER_OUT=str(tmp_path / "out"))
    r = _run("render-parity.sh", env=env)
    assert r.returncode == 0 and r.stdout.startswith("SKIPPED"), r.stdout
    r = _run("render-parity.sh", "--devices=4", env=env)
    assert r.returncode == 2 and r.stdout.startswith("usage"), r.stdout
    r = _run("render-parity.sh",
             env=dict(NBODY_RENDER_OUT=os.path.join(OUT, "render_parity")))
    assert r.returncode == 2 and r.stdout.startswith("REFUSED"), r.stdout


def test_boundary_digits_on_a_saved_state(tmp_path):
    """bin/torch/boundary_digits.py on a state the CLI saved: each row's
    y-force four ways; away from a rounding boundary all four print the
    same digits, and K1's (its plain version's, which --pallas ran) is the
    next step's force."""
    from parallel_nbody_tpu_torch.utils import ppm
    arena = str(tmp_path / "arena.ppm")
    ppm.create(arena, 1024, 768)
    env = dict(os.environ, PYTHONPATH=REPO, NBODY_PLATFORM="cpu")
    ck = str(tmp_path / "s.npz")
    for steps, extra in ((10, ["--checkpoint=" + ck]), (11, [])):
        r = subprocess.run(
            [sys.executable, "-m", "parallel_nbody_tpu_torch.cli", "64", "0",
             arena, str(steps), "--pallas", "--dtype=float64"] + extra,
            capture_output=True, text=True, env=env, timeout=300)
        assert r.returncode == 0, r.stderr
    nxt = r.stdout.splitlines()
    r = subprocess.run(
        [sys.executable, os.path.join(BIN, "boundary_digits.py"), ck, "5",
         "40"], capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    for row in (5, 40):
        lines = [l for l in r.stdout.splitlines()
                 if l.startswith("body %d y-force" % row)]
        assert len(lines) == 4
        assert {l.split()[-1] for l in lines} == {nxt[row].split()[3]}


# ---------------------------------------------------------------------------
# slow: the full replay and render-parity at N=10000
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("kind", sorted(STREAMS))
def test_full_replay_of_the_recorded_seeds(kind, tmp_path):
    """Every recorded seed of the stream through its script on the CPU
    (the committed records' run; ~30 min for all four on 8 cores)."""
    script, sweeps, jax_dir, _ = STREAMS[kind]
    for seed, count in sweeps:
        r = _run(script, count, seed, timeout=3600,
                 env=_hermetic(tmp_path,
                               NBODY_FUZZ_PORT=str(_free_port() - 1)))
        assert r.returncode == 0, r.stdout + r.stderr
    _check_records(kind, sweeps, os.path.join(OUT, jax_dir),
                   str(tmp_path / "out"))


@pytest.mark.slow
@pytest.mark.parametrize("flags", [[], ["--devices=4"], ["--mesh2d=2x4"]])
def test_render_parity_at_n10000(flags, tmp_path):
    """The reference binary's own frame at N=10000 after 3 steps, by one
    rank and by gloo ranks drawing on rank 0 (~10 GB of pair matrices on
    one rank)."""
    r = _run("render-parity.sh", 3, *flags, timeout=1800,
             env=dict(NBODY_RENDER_OUT=str(tmp_path)))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "PASSED ppm" in r.stdout and "PASSED stdout" in r.stdout, r.stdout
