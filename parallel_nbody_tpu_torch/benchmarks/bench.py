"""Headline benchmark of the port: unordered pairwise interactions per
second of the fused step on one card.

The counterpart of the root ``bench.py`` (its ``:106-156``): N=65536 bodies
from ``state.random_state`` (a ``torch.Generator`` seeded with 0), 100
steps of ``engine.run`` in fp32 with ``kernel="cuda"`` (the force pass is
K1, ``csrc/forces.cu``), one warm-up run, then the best of 5 timed runs,
each ending in ``torch.cuda.synchronize()``, and a check that the state
is finite.  The rate counts ``n(n-1)/2 * steps`` pairs
(``utils/output.pair_interactions``), as the root ``bench.py:147`` does.

Baseline, as there: the reference's best published throughput, N=10000 on
P=128 cores of DAS-5 in 11.23 s for 100 steps, 4.45e8 pairs/s for the whole
cluster; ``vs_baseline`` is this card's rate over that.

    python -m parallel_nbody_tpu_torch.benchmarks.bench [--device=cpu]

prints one JSON line with the root line's keys (``metric``, ``value``,
``unit``, ``vs_baseline``) and ``fingerprint``.  Without a card it exits 1
and prints nothing on stdout.  ``--device=cpu`` runs the root tool's CPU
size, N=4096 for 10 steps, through the kernels' plain versions, and the
metric says so.  The root tool's probe of a wedged TPU transport has no
counterpart.

``NBODY_BENCH_ROWS=R`` cuts each step's force pass into N/R launches of
K1 (``block_forces_auto``), each over R rows (``row_g0`` at their first)
against all N columns, as an all-gather rank calls it: the same forces,
bit for bit, from launches that each hold R/128 thread blocks.  It is the
perf gate's sabotage (``perf_gate.py``): at R=8192 each launch fills 64 of
the card's 132 SMs with one block of four warps, so the pass runs several
times slower than one launch of 512 blocks.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from ..config import SimConfig
from ..models.engine import run
from ..ops.cuda_step import block_forces_auto, forces_coincident_dispatch
from ..ops.integrate import compute_positions, compute_velocities
from ..state import State, random_state
from ..utils.output import pair_interactions
from ..utils.device import tool_argv
from ._tools import fingerprint, sync, wall

N, STEPS, REPS = 65536, 100, 5
CPU_N, CPU_STEPS = 4096, 10
SEED = 0
BASELINE_CLUSTER_RATE = 4.45e8  # reference best, whole 128-core cluster
ROWS_ENV = "NBODY_BENCH_ROWS"


def bench_cfg() -> SimConfig:
    return SimConfig(force_mode="fast", dtype="float32", kernel="cuda")


def row_block_step(cfg: SimConfig, s: State, rows: int) -> State:
    """``engine.step`` with its force pass cut into launches over ``rows``
    rows each (the sabotage)."""

    def forces(biased):
        parts = [block_forces_auto(
            cfg, s.x[r0:r0 + rows], s.y[r0:r0 + rows], s.mass[r0:r0 + rows],
            s.radius[r0:r0 + rows], s.x, s.y, s.mass, s.radius, row_g0=r0,
            biased=biased, accum=cfg.accum) for r0 in range(0, s.n, rows)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))

    xf, yf = forces_coincident_dispatch(s.x, s.y, s.mass, forces)
    xv, yv = compute_velocities(cfg, s.xv, s.yv, xf, yf, s.mass)
    x, y, xv, yv = compute_positions(cfg, s.x, s.y, xv, yv, mass=s.mass)
    return State(x, y, xv, yv, xf, yf, s.mass, s.radius)


def runner(cfg: SimConfig, steps: int, rows: int | None):
    """``state -> state`` over ``steps`` steps: ``engine.run``, or with
    ``rows`` the same loop with the force pass in row blocks (the
    sabotage)."""
    if not rows:
        return lambda s: run(cfg, s, steps)

    def go(s):
        for _ in range(steps):
            s = row_block_step(cfg, s, rows)
        return s

    return go


def metric(n: int, device, rows: int | None) -> str:
    path = "K1 in launches of %d rows" % rows if rows else "K1"
    if device.type == "cpu":
        return ("pairwise interactions/s (N=%d, fp32 step, %s's plain "
                "version on the CPU)" % (n, path))
    return ("pairwise interactions/s/chip (N=%d, fused fp32 CUDA step, %s)"
            % (n, path))


def headline(device, rows: int | None = None, n: int | None = None,
             steps: int | None = None, reps: int | None = None) -> dict:
    """The benchmark's payload on ``device`` (N and steps default to the
    card's or the CPU's size, reps to ``REPS``)."""
    on_card = device.type == "cuda"
    n = n or (N if on_card else CPU_N)
    steps = steps or (STEPS if on_card else CPU_STEPS)
    cfg = bench_cfg()
    gen = torch.Generator(device=device).manual_seed(SEED)
    state = random_state(n, cfg, gen, device=device)
    go = runner(cfg, steps, rows)
    out = go(state)  # warm-up: the build and a first run
    sync(device)
    rtime = float("inf")
    for _ in range(reps or REPS):
        seconds, out = wall(lambda: go(out), device)
        rtime = min(rtime, seconds)
    if not all(bool(torch.isfinite(t).all()) for t in out):
        return {"error": "non-finite state", "fingerprint":
                fingerprint(device)}
    rate = pair_interactions(n, steps) / rtime
    return {
        "metric": metric(n, device, rows),
        "value": round(rate, 1),
        "unit": "pairs/s",
        "vs_baseline": round(rate / BASELINE_CLUSTER_RATE, 2),
        "fingerprint": fingerprint(device),
    }


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    got = tool_argv("bench", argv, ("device",))
    if got is None:
        return 1
    _, _, device = got
    rows = int(os.environ.get(ROWS_ENV) or 0) or None
    payload = headline(device, rows)
    print(json.dumps(payload))
    return 1 if "error" in payload else 0


if __name__ == "__main__":
    sys.exit(main())
