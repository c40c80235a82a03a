"""On-card accuracy gate for the CUDA force kernels, against float64.

The counterpart of the JAX package's ``benchmarks/hw_validate.py``.  The
kernels' comparisons with their plain versions (``chip_smoke.py``, the card
tests) hold the same fp32 arithmetic to itself; this gate holds the speed
configuration (fp32, ``kernel="cuda"``) to a float64 oracle:

  case A  K1 — N=4096 glibc init (it holds coincident pairs, so the biased
          kernel and the dx-bias kick run), 20 steps, positions and
          velocities against the float64 trajectory.
  case F  case A with ``accum="compensated"``.
  case B  the same trajectory with the force pass through K2 at a forced
          band of 1024: 4 bands, so the fold of band partials runs
          (``make_streamed_run``).
  case B' case B with ``accum="compensated"`` (the Kahan fold across
          bands).
  R0-R2   three configurations drawn from ``random.Random(1)``: N in
          [1024, 8192], steps in [5, 30], K1 or K2 at band 1024, plain or
          compensated; each against its own float64 trajectory.  The
          velocity quantile is p90 here, not p99: a glibc init carries
          ~N^2 / (2 * 1024 * 768) coincident pairs whose members diverge
          by ~3e-3 between fp32 and fp64, and at N=8192 they reach the p99
          rank.
  case C  N=262144 (past K1's range: on the card the symmetric pass in
          row launches, K2 before it): the force operator on the first
          4096 rows against float64 rows, on the initial state and on the
          state the card evolved for 20 steps.
  D, D', E the ring, all-gather and 1x1-grid programs (``parallel/``) in a
          process group of this process alone, 20 steps at N=262144,
          against case C's trajectory (bit-equal expected).
  sabotage case A with gravity's sign flipped must FAIL the tolerances.

The float64 oracle runs in the same process on the same device through the
dense path (``engine.run`` with ``kernel="dense"``, ``ops.forces
.forces_on_block`` 512 rows at a time), plain tensor code that shares
nothing with K1 or K2.

    python -m parallel_nbody_tpu_torch.benchmarks.hw_validate \\
        [--device=cpu|cuda] [--out=PATH]

prints the verdict as JSON and ``HW_VALIDATE PASS`` or ``FAIL``, writes it
to PATH when given, and exits 0 on PASS, 1 on FAIL or without a CUDA device
(unless ``--device=cpu``).  On the CPU the kernels' plain versions run, at
the reduced sizes ``CPU_SIZES`` (the tests' sizes), where case C stays
below K2's threshold and runs K1.

Tolerances (fp32 kernels against fp64, unchanged from the JAX gate):
positions absolute ``TOL_POS`` (values are O(1000)); velocities relative
with a floor of 1 (``|d| / (|v| + 1)``), the p99 (p90 for R0-R2) under
``TOL_VEL_P99`` and the maximum under ``TOL_VEL_MAX``: coincident pairs
separate a step or two apart in fp32 and fp64, which leaves their members
~3e-3 apart while every other body agrees to ~1e-6; forces relative with a
floor of 1 under ``TOL_FORCE``.  The programs against the fused run:
relative (floor 1) under ``TOL_PROGRAM``.
"""

from __future__ import annotations

import json
import os
import random
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from ..config import SimConfig
from ..models.engine import run
from ..ops.cuda_step import (band_width, block_forces_streamed, cuda_forces,
                             forces_coincident_dispatch)
from ..ops.forces import forces_on_block
from ..ops.integrate import compute_positions, compute_velocities
from ..state import State, init_state
from ..utils.device import resolve, tool_argv
from ..utils.output import _host64
from ._tools import device_keys

N_SMALL = 4096
N_LARGE = 262144
STEPS = 20
ROWS_CHECKED = 4096  # leading rows of case C checked against the oracle
ORACLE_ROW_CHUNK = 512
BAND = 1024  # the forced band of cases B, B' and the streamed random cases

# The seeded random configurations.  Seed 1's three draws cover both
# variants and both accumulations.
RANDOM_SEED = 1
RANDOM_COUNT = 3

TOL_POS = 2e-2
TOL_VEL_P99 = 1e-5
TOL_VEL_MAX = 1e-2
TOL_FORCE = 2e-3
TOL_PROGRAM = 1e-4

STATE_FIELDS = ("x", "y", "xv", "yv", "xf", "yf")


class Sizes(NamedTuple):
    """The gate's sizes: case A's N, case C's N, the steps, case C's rows,
    the forced band, and the divisor of the random cases' N."""

    n_small: int
    n_large: int
    steps: int
    rows_checked: int
    band: int
    random_divisor: int


FULL_SIZES = Sizes(N_SMALL, N_LARGE, STEPS, ROWS_CHECKED, BAND, 1)
# The CPU's sizes: the kernels' plain versions at 1/4 of case A's width and
# 1/8 of the random cases'; band 256 still cuts case B's 1024 columns into 4
# bands.
CPU_SIZES = Sizes(1024, 1024, STEPS, 256, 256, 8)


def random_case_specs():
    """The seeded random configurations (the draw order fixes what R{i}
    means)."""
    rng = random.Random(RANDOM_SEED)
    specs = []
    for _ in range(RANDOM_COUNT):
        specs.append({"n": rng.randint(1024, 8192),
                      "steps": rng.randint(5, 30),
                      "variant": rng.choice(["resident", "streamed"]),
                      "accum": rng.choice(["plain", "compensated"])})
    return specs


def cfg32(**kw) -> SimConfig:
    """The speed configuration the gate holds to float64."""
    return SimConfig(force_mode="fast", dtype="float32", kernel="cuda", **kw)


ORACLE_CFG = SimConfig(force_mode="fast", dtype="float64", kernel="dense")


def make_streamed_run(cfg: SimConfig, steps: int, band: int):
    """``engine.run`` with the force pass through K2
    (``block_forces_streamed``) at ``band`` columns a band, so several
    bands and their fold run at any N; the coincident-pair flag as in
    ``engine.step``.  Returns ``run(state) -> state``."""

    def step(s: State) -> State:
        xf, yf = forces_coincident_dispatch(
            s.x, s.y, s.mass,
            lambda biased: block_forces_streamed(
                cfg, s.x, s.y, s.mass, s.radius, s.x, s.y, s.mass, s.radius,
                band=band, biased=biased, accum=cfg.accum))
        xv, yv = compute_velocities(cfg, s.xv, s.yv, xf, yf, s.mass)
        x, y, xv, yv = compute_positions(cfg, s.x, s.y, xv, yv, mass=s.mass)
        return State(x, y, xv, yv, xf, yf, s.mass, s.radius)

    def run_streamed(s: State) -> State:
        for _ in range(steps):
            s = step(s)
        return s

    return run_streamed


def oracle_trajectory(state: State, steps: int) -> State:
    """The float64 trajectory from ``state`` (cast up): ``engine.run`` on
    the dense fast path."""
    return run(ORACLE_CFG, State(*(t.to(torch.float64) for t in state)),
               steps)


def oracle_forces(x, y, mass, radius, rows: int,
                  chunk: int = ORACLE_ROW_CHUNK):
    """Float64 forces on bodies [0, rows) from every body, ``chunk`` rows
    at a time (``forces_on_block``, one-sided, global ids for the
    coincident kick).  Inputs are cast up to float64."""
    x, y, mass, radius = (t.to(torch.float64) for t in (x, y, mass, radius))
    fxs, fys = [], []
    for r0 in range(0, rows, chunk):
        sl = slice(r0, min(rows, r0 + chunk))
        fx, fy = forces_on_block(ORACLE_CFG, x[sl], y[sl], mass[sl],
                                 radius[sl], x, y, mass, radius,
                                 same_block=False, gi0=r0, gj0=0)
        fxs.append(fx)
        fys.append(fy)
    return torch.cat(fxs), torch.cat(fys)


def err_stats(got, want, q: float = 99):
    """(max |d|, max |d| / (|want| + 1), q-th percentile of the latter)
    between ``got`` and the float64 ``want``."""
    g, w = _host64(got), _host64(want)
    d = np.abs(g - w)
    rel = d / (np.abs(w) + 1.0)
    return float(d.max()), float(rel.max()), float(np.percentile(rel, q))


def trajectory_case(end: State, want: State, q: float = 99) -> dict:
    """The worst position error and velocity errors of ``end`` against the
    oracle's ``want``, and whether they are within the tolerances."""
    pos = max(err_stats(end.x, want.x)[0], err_stats(end.y, want.y)[0])
    sx, sy = err_stats(end.xv, want.xv, q), err_stats(end.yv, want.yv, q)
    vel_max, vel_q = max(sx[1], sy[1]), max(sx[2], sy[2])
    return {"pos_max_abs": pos, "vel_max_rel": vel_max,
            "vel_p%d_rel" % q: vel_q,
            "ok": pos < TOL_POS and vel_max < TOL_VEL_MAX
            and vel_q < TOL_VEL_P99}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _programs(cfg, state, want, steps, device, tmp, log):
    """Cases D, D' and E: the ring, all-gather and 1x1-grid programs in a
    process group of this process alone (NCCL on the card, gloo on the
    CPU, joined through a FileStore in ``tmp``), each against the fused
    run's ``want``.  The group is destroyed before returning."""
    import torch.distributed as dist

    from ..parallel.grid2d import (make_grid2d_run, make_mesh2d,
                                   shard_state_2d)
    from ..parallel.mesh import make_mesh, shard_state
    from ..parallel.sharded_step import make_sharded_run

    if dist.is_initialized():
        raise RuntimeError("hw_validate: a process group is already "
                           "initialized; cases D, D' and E open their own")
    store = dist.FileStore(os.path.join(tmp, "store"), 1)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=store, rank=0, world_size=1)
    out = {}
    try:
        mesh = make_mesh(1, device.type)
        mesh2 = make_mesh2d(1, 1, device.type)
        runs = (("D", "ring", make_sharded_run(cfg, mesh, steps, "ring"),
                 shard_state(state, mesh, device)),
                ("D'", "allgather",
                 make_sharded_run(cfg, mesh, steps, "allgather"),
                 shard_state(state, mesh, device)),
                ("E", "grid2d", make_grid2d_run(cfg, mesh2, steps),
                 shard_state_2d(state, mesh2, device)))
        for case, name, runner, shard in runs:
            t0 = time.perf_counter()
            end = runner(shard)
            _sync(device)
            seconds = time.perf_counter() - t0
            stats = {f + "_max_rel": err_stats(getattr(end, f),
                                               getattr(want, f))[1]
                     for f in STATE_FIELDS}
            out[name] = {**stats,
                         "ok": all(v < TOL_PROGRAM for v in stats.values()),
                         "bit_identical": all(v == 0.0
                                              for v in stats.values())}
            log("case %s (%s program, N=%d, %d steps) ran in %.3f s: %s"
                % (case, name, state.n, steps, seconds, out[name]))
    finally:
        dist.destroy_process_group()
    return out


def run_gate(device=None, sizes: Sizes | None = None, log=print) -> dict:
    """Run every case on ``device`` (the card unless "cpu" is asked for)
    and its float64 oracle; returns the verdict (``"ok"`` is the gate's
    result).  ``sizes`` defaults to ``FULL_SIZES`` on the card and
    ``CPU_SIZES`` on the CPU."""
    device = resolve(device)
    if sizes is None:
        sizes = FULL_SIZES if device.type == "cuda" else CPU_SIZES
    n, steps, band = sizes.n_small, sizes.steps, sizes.band
    bands = -(-n // band_width(n, band))
    if bands < 2:
        raise ValueError("hw_validate: band %d gives %d band at N=%d; cases "
                         "B and B' need several" % (band, bands, n))
    cfg = cfg32()
    cases, ends = {}, {}

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        log("%s ran in %.3f s" % (label, time.perf_counter() - t0))
        return out

    # --- the card's runs at N_SMALL, then their float64 oracle ------------
    st = init_state(n, cfg, device=device)
    ends["A"] = timed("case A (K1, N=%d, %d steps)" % (n, steps),
                      lambda: run(cfg, st, steps))
    ends["F"] = timed("case F (K1 compensated)", lambda: run(
        cfg.replace(accum="compensated"), st, steps))
    ends["B"] = timed("case B (K2, band %d: %d bands)" % (band, bands),
                      lambda: make_streamed_run(cfg, steps, band)(st))
    ends["B'"] = timed("case B' (K2 compensated, %d bands)" % bands,
                       lambda: make_streamed_run(
                           cfg.replace(accum="compensated"), steps,
                           band)(st))
    ends["sabotage"] = timed("sabotage (gravity flipped)", lambda: run(
        cfg.replace(gravity=-cfg.gravity), st, steps))
    want = timed("oracle trajectory (N=%d, %d steps, float64)" % (n, steps),
                 lambda: oracle_trajectory(
                     init_state(n, ORACLE_CFG, device=device), steps))
    for case in ("A", "B", "F", "B'"):
        cases[case] = trajectory_case(ends[case], want)
    sab = trajectory_case(ends["sabotage"], want)
    cases["sabotage"] = {"pos_max_abs": sab["pos_max_abs"],
                         "vel_max_rel": sab["vel_max_rel"],
                         "detected": sab["pos_max_abs"] >= TOL_POS
                         or sab["vel_max_rel"] >= TOL_VEL_MAX}

    # --- the seeded random configurations ---------------------------------
    random_cases = []
    for i, spec in enumerate(random_case_specs()):
        spec = {**spec, "n": spec["n"] // sizes.random_divisor}
        c = cfg.replace(accum=spec["accum"])
        stR = init_state(spec["n"], c, device=device)
        runner = (make_streamed_run(c, spec["steps"], band)
                  if spec["variant"] == "streamed"
                  else lambda s, c=c, k=spec["steps"]: run(c, s, k))
        endR = timed("random case R%d %s" % (i, spec), lambda: runner(stR))
        wantR = oracle_trajectory(
            init_state(spec["n"], ORACLE_CFG, device=device), spec["steps"])
        random_cases.append({**spec, **trajectory_case(endR, wantR, q=90)})
        log("random case R%d: %s" % (i, random_cases[-1]))

    # --- case C: the force operator at N_LARGE ----------------------------
    nl, rows = sizes.n_large, sizes.rows_checked
    stC = init_state(nl, cfg, device=device)

    def forces(s):
        fx, fy = cuda_forces(cfg, s.x, s.y, s.mass, s.radius, biased=True)
        return fx[:rows], fy[:rows]

    f0 = timed("case C forces at step 0 (N=%d)" % nl, lambda: forces(stC))
    endC = timed("case C run (N=%d, %d steps)" % (nl, steps),
                 lambda: run(cfg, stC, steps))
    f20 = forces(endC)
    st64 = init_state(nl, ORACLE_CFG, device=device)
    w0 = timed("oracle forces at step 0 (%d x %d, float64)" % (rows, nl),
               lambda: oracle_forces(st64.x, st64.y, st64.mass, st64.radius,
                                     rows))
    # On the positions the card evolved, cast up: the force operator alone,
    # apart from any divergence of the trajectory.
    w20 = oracle_forces(endC.x, endC.y, st64.mass, st64.radius, rows)
    f0_rel = max(err_stats(g, w)[1] for g, w in zip(f0, w0))
    f20_rel = max(err_stats(g, w)[1] for g, w in zip(f20, w20))
    cases["C"] = {"force_step0_max_rel": f0_rel,
                  "force_step20_max_rel": f20_rel,
                  "ok": f0_rel < TOL_FORCE and f20_rel < TOL_FORCE}

    # --- cases D, D', E: the programs against case C's run ----------------
    with tempfile.TemporaryDirectory(prefix="hw_validate_") as tmp:
        programs = _programs(cfg, stC, endC, steps, device, tmp, log)

    ok = (all(c["ok"] for k, c in cases.items() if k != "sabotage")
          and cases["sabotage"]["detected"]
          and all(c["ok"] for c in random_cases)
          and all(p["ok"] for p in programs.values()))
    return {"cases": cases, "ok": ok,
            "random_cases": {"seed": RANDOM_SEED, "cases": random_cases},
            "tolerances": {"pos_abs": TOL_POS, "vel_rel_max": TOL_VEL_MAX,
                           "vel_rel_p99": TOL_VEL_P99,
                           "force_rel": TOL_FORCE,
                           "program_rel": TOL_PROGRAM},
            "n_small": n, "n_large": nl, "steps": steps,
            "rows_checked": rows, "band": band, "bands": bands,
            "parallel_programs": programs, **device_keys(device)}


def summary_lines(verdict: dict):
    """One line per case: its worst errors beside their tolerances."""
    t = verdict["tolerances"]
    for case in ("A", "F", "B", "B'"):
        c = verdict["cases"][case]
        yield ("case %-8s pos %.6e < %g, vel max %.6e < %g, vel p99 %.6e "
               "< %g: %s" % (case, c["pos_max_abs"], t["pos_abs"],
                             c["vel_max_rel"], t["vel_rel_max"],
                             c["vel_p99_rel"], t["vel_rel_p99"],
                             "ok" if c["ok"] else "FAIL"))
    for i, c in enumerate(verdict["random_cases"]["cases"]):
        yield ("case R%d       N=%d %d steps %s %s: pos %.6e < %g, vel max "
               "%.6e < %g, vel p90 %.6e < %g: %s"
               % (i, c["n"], c["steps"], c["variant"], c["accum"],
                  c["pos_max_abs"], t["pos_abs"], c["vel_max_rel"],
                  t["vel_rel_max"], c["vel_p90_rel"], t["vel_rel_p99"],
                  "ok" if c["ok"] else "FAIL"))
    c = verdict["cases"]["C"]
    yield ("case C        force step 0 %.6e < %g, step %d %.6e < %g: %s"
           % (c["force_step0_max_rel"], t["force_rel"], verdict["steps"],
              c["force_step20_max_rel"], t["force_rel"],
              "ok" if c["ok"] else "FAIL"))
    for case, name in (("D", "ring"), ("D'", "allgather"), ("E", "grid2d")):
        p = verdict["parallel_programs"][name]
        worst = max(p[f + "_max_rel"] for f in STATE_FIELDS)
        yield ("case %-8s %s program vs the fused run: max rel %.6e < %g, "
               "bit-identical %s: %s" % (case, name, worst,
                                         t["program_rel"],
                                         p["bit_identical"],
                                         "ok" if p["ok"] else "FAIL"))
    c = verdict["cases"]["sabotage"]
    yield ("sabotage      pos %.6e (>= %g trips), vel max %.6e (>= %g "
           "trips): %s" % (c["pos_max_abs"], t["pos_abs"], c["vel_max_rel"],
                           t["vel_rel_max"],
                           "detected" if c["detected"] else "NOT DETECTED"))


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    got = tool_argv("hw_validate", argv)
    if got is None:
        return 1
    _, flags, device = got
    verdict = run_gate(device, log=lambda s: print(s, flush=True))
    verdict["when"] = time.strftime("%Y-%m-%d %H:%M:%S")
    for line in summary_lines(verdict):
        print(line)
    if flags.get("out"):
        with open(flags["out"], "w") as f:
            json.dump(verdict, f, indent=2)
            f.write("\n")
    print(json.dumps(verdict, indent=2))
    print("HW_VALIDATE %s" % ("PASS" if verdict["ok"] else "FAIL"))
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
