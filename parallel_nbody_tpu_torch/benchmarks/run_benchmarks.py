"""Benchmark suite in the shape of the reference's experiment tables, and
the port's scaling grid through K1 and K2.

The counterpart of the JAX package's ``benchmarks/run_benchmarks.py``:

  - ``seq_grid``: N in {512, 1024, 4096, 10000} (``--quick``: 512, 1024),
    100 steps (``--quick``: 10) of the dense fast path (``kernel="dense"``),
    fp32 on the card and float64 on the CPU, as the JAX tool chooses off
    and on the CPU: seconds, GFLOPS by the reference's model and pairs/s.
  - ``cuda_grid`` (on the card only): N in {4096, 16384, 65536, 262144,
    1048576, 2097152} (``--quick``: 4096, 16384) through ``engine.run`` in
    fp32 with ``kernel="cuda"`` (K1's symmetric pass, and above 131072
    bodies the symmetric pass in row launches, in K2's place), with the
    JAX tool's step count ``k`` (about 2e11 pair evaluations, 3 to 200
    steps), after one warm-up step, timed on the host clock between two
    ``torch.cuda.synchronize()``.  The JAX tool's per-dispatch ``chunk``
    exists for a TPU transport and has no counterpart.  From
    ``HOLD_FROM`` = 1048576 bodies up, where K2 had not run on the card
    before, the size's first force pass is held against
    ``block_forces_streamed_reference`` on ``HOLD_ROWS`` rows (four blocks
    of 1024, at offsets that are not multiples of 128, so the bias
    segments are those of misaligned blocks), before it is timed:
    ``|kernel - plain| <= HOLD_TOL * max|plain|``.  Both sum each row in
    the same order — 128-column tiles folded in order within each band of
    65536, then the bands in order — and differ only inside a tile (the
    kernel adds term by term, the plain version as ``torch.sum`` does), so
    the difference grows like the square root of the tile count: on the
    H100 it measured 1.8e-7 of max|F| at N=1048576 and 2.7e-7 at 2097152,
    and HOLD_TOL = 2e-6 (chip_smoke.py's bound for K1 and K2) leaves a
    factor of 7.  The symmetric pass, which makes that first pass on the
    card since it took K2's square fp32 calls, sums each pair once in
    another order, and is held to the same bound.
  - ``shard_grid``: N=8192 (``--quick``: 1024), 100 steps (``--quick``:
    10), the all-gather and ring programs over every card through the CLI
    (``--devices=K --fast --run-xps``, one NCCL rank a card); on the CPU
    two gloo ranks.  It needs more than one card: on one card it records
    why it was skipped and no number.

    python -m parallel_nbody_tpu_torch.benchmarks.run_benchmarks \\
        [--quick] [--device=cpu] [--out=PATH]

prints the report as JSON and writes it to PATH (on the card by default
``benchmarks/results.json`` beside this module; a CPU run only where
``--out`` says).  Without a card it exits 1.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import torch

from ..config import SimConfig
from ..models.engine import run
from ..ops.cuda_step import (STREAM_BAND, block_forces_streamed_reference,
                             cuda_forces, any_coincident)
from ..state import random_state
from ..utils import ppm
from ..utils.output import nr_flops, pair_interactions
from ..utils.device import tool_argv
from ._tools import REPO, fingerprint, record_path, wall, write_record

SEQ_SIZES = (512, 1024, 4096, 10000)
QUICK_SEQ_SIZES = (512, 1024)
GRID_SIZES = (4096, 16384, 65536, 262144, 1048576, 2097152)
QUICK_GRID_SIZES = (4096, 16384)
HOLD_FROM = 1 << 20
HOLD_ROWS, HOLD_BLOCK = 4096, 1024
HOLD_TOL = 2e-6
SHARD_N, QUICK_SHARD_N = 8192, 1024
CPU_SHARD_RANKS = 2
SEED = 0


def grid_steps(n: int) -> int:
    """The JAX tool's step count: about 2e11 pair evaluations, 3 to 200
    steps."""
    return max(3, min(200, int(2e11 // (n * n // 2))))


def time_run(cfg, state, steps, device) -> float:
    """Seconds of ``steps`` steps of ``engine.run`` after one warm-up
    step, between two synchronizations."""
    state = run(cfg, state, 1)
    seconds, _ = wall(lambda: run(cfg, state, steps), device)
    return seconds


def seq_grid(device, quick: bool) -> dict:
    steps = 10 if quick else 100
    dtype = "float64" if device.type == "cpu" else "float32"
    cfg = SimConfig(force_mode="fast", dtype=dtype, kernel="dense")
    grid = {}
    for n in QUICK_SEQ_SIZES if quick else SEQ_SIZES:
        gen = torch.Generator(device=device).manual_seed(SEED)
        st = random_state(n, cfg, gen, device=device)
        rtime = time_run(cfg, st, steps, device)
        grid[n] = {
            "steps": steps,
            "rtime_s": round(rtime, 4),
            "gflops": round(nr_flops(n, steps) / 1e9 / rtime, 2),
            "pairs_per_s": round(pair_interactions(n, steps) / rtime, 1),
        }
    return grid


def hold_rows(n: int):
    """The first rows of the four held blocks: spread over the bodies,
    none a multiple of 128."""
    last = n - HOLD_BLOCK - 1
    return [1, n // 3 + 37, 2 * n // 3 + 101, last]


def hold_first_pass(cfg, state) -> dict:
    """The first force pass at ``state`` (``cuda_forces``, as the step
    makes it) against K2's plain version on ``HOLD_ROWS`` rows."""
    s = state
    biased = any_coincident(s.x, s.y, s.mass)
    fx, fy = cuda_forces(cfg, s.x, s.y, s.mass, s.radius, biased=biased)
    worst, scale = 0.0, 0.0
    for r0 in hold_rows(s.n):
        rows = slice(r0, r0 + HOLD_BLOCK)
        wx, wy = block_forces_streamed_reference(
            cfg, s.x[rows], s.y[rows], s.mass[rows], s.radius[rows],
            s.x, s.y, s.mass, s.radius, row_g0=r0, band=STREAM_BAND,
            biased=biased)
        scale = max(scale, float(wx.abs().max()), float(wy.abs().max()))
        worst = max(worst, float((fx[rows] - wx).abs().max()),
                    float((fy[rows] - wy).abs().max()))
    ok = worst <= HOLD_TOL * scale and bool(torch.isfinite(fx).all())
    return {"rows": HOLD_ROWS, "row_starts": hold_rows(s.n),
            "max_abs_err": worst, "max_abs_plain": scale,
            "rel_to_max": worst / scale, "tol": HOLD_TOL, "ok": ok}


def cuda_grid(device, quick: bool, log=print) -> dict:
    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
    grid = {}
    for n in QUICK_GRID_SIZES if quick else GRID_SIZES:
        gen = torch.Generator(device=device).manual_seed(SEED)
        st = random_state(n, cfg, gen, device=device)
        row = {}
        if n >= HOLD_FROM:
            row["hold"] = hold_first_pass(cfg, st)
            log("hold N=%d: %s" % (n, json.dumps(row["hold"])))
            if not row["hold"]["ok"]:
                raise AssertionError("the pass at N=%d disagrees with K2's "
                                     "plain version: %s" % (n, row["hold"]))
        k = grid_steps(n)
        rtime = time_run(cfg, st, k, device)
        row.update(steps=k, ms_per_step=rtime / k * 1e3,
                   pairs_per_s=pair_interactions(n, k) / rtime)
        log("cuda_grid N=%d: %d steps, %.6f ms/step, %.6e pairs/s"
            % (n, k, row["ms_per_step"], row["pairs_per_s"]))
        grid[n] = row
    return grid


def shard_grid(device, quick: bool) -> dict:
    """The all-gather and ring programs over every card (the CPU: two gloo
    ranks) through the CLI's experiment row."""
    ranks = (torch.cuda.device_count() if device.type == "cuda"
             else CPU_SHARD_RANKS)
    if ranks < 2:
        return {"skipped": "the shard grid needs more than one card; this "
                           "machine has %d (NCCL takes one rank a card)"
                           % ranks}
    n, steps = (QUICK_SHARD_N, 10) if quick else (SHARD_N, 100)
    env = dict(os.environ, NBODY_PLATFORM=device.type)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    grid = {}
    with tempfile.TemporaryDirectory() as tmp:
        arena = os.path.join(tmp, "arena.ppm")
        ppm.create(arena, 1024, 768)
        for comm in ("allgather", "ring"):
            proc = subprocess.run(
                [sys.executable, "-m", "parallel_nbody_tpu_torch.cli",
                 str(n), "0", arena, str(steps), "--run-xps", "--fast",
                 "--dtype=float32", "--devices=%d" % ranks,
                 "--comm=%s" % comm],
                capture_output=True, text=True, env=env, cwd=REPO,
                timeout=900)
            if proc.returncode != 0:
                raise RuntimeError("shard grid %s: rc %d: %s" % (
                    comm, proc.returncode, proc.stderr[-500:]))
            # SIZE,NODES,CPUS_PER_NODE,NBODIES,RTIME,... (nbody-par.c:956)
            rtime = float(proc.stdout.strip().splitlines()[-1]
                          .split(",")[4])
            grid[comm] = {
                "n": n, "devices": ranks, "steps": steps,
                "rtime_s": rtime,
                "pairs_per_s": round(pair_interactions(n, steps) / rtime, 1),
            }
    return grid


def report(device, quick: bool = False, log=print) -> dict:
    rep = {"backend": device.type, "device": str(device)}
    rep["seq_grid"] = seq_grid(device, quick)
    if device.type == "cuda":
        rep["cuda_grid"] = cuda_grid(device, quick, log)
    rep["shard_grid"] = shard_grid(device, quick)
    rep["fingerprint"] = fingerprint(device)
    return rep


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    quick = "--quick" in argv[1:]
    got = tool_argv("run_benchmarks", [a for a in argv if a != "--quick"])
    if got is None:
        return 1
    _, flags, device = got
    rep = report(device, quick, log=lambda s: print(s, flush=True))
    print(json.dumps(rep, indent=2))
    write_record(rep, record_path(flags, device, "results.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
