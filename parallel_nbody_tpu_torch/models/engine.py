"""Single-device simulation engine.

The reference's hot loop (nbody-seq.c:457-472) is
``clear_forces -> compute_forces -> compute_velocities -> compute_positions``
with a buffer flip.  Here ``run`` is a Python loop of ``step``, each step a
sequence of eager tensor ops on the state's device; with ``kernel="cuda"``
the force pass is one call of a hand-written kernel (K1, or K2 above 131072
bodies; ops/cuda_step.cuda_forces).  Nothing in the
loop reads a value back to the host, so on a GPU the launches queue without
waiting for the device.
"""

from __future__ import annotations

from ..config import SimConfig
from ..ops.cuda_step import cuda_forces, forces_coincident_dispatch
from ..ops.forces import compute_forces_dense
from ..ops.integrate import compute_positions, compute_velocities
from ..state import State


def step(cfg: SimConfig, state: State) -> State:
    """One simulation step (force -> velocity -> position)."""
    if cfg.kernel == "cuda":
        # The coincidence flag stays on the device: the kernel reads it and
        # adds the reference's atan2(0,0) kick (nbody-seq.c:91-106) only on
        # steps that hold coincident distinct bodies.
        xf, yf = forces_coincident_dispatch(
            state.x, state.y, state.mass,
            lambda biased: cuda_forces(cfg, state.x, state.y, state.mass,
                                       state.radius, biased=biased,
                                       accum=cfg.accum))
    else:
        xf, yf = compute_forces_dense(cfg, state.x, state.y, state.mass,
                                      state.radius)
    xv, yv = compute_velocities(cfg, state.xv, state.yv, xf, yf, state.mass)
    x, y, xv, yv = compute_positions(cfg, state.x, state.y, xv, yv,
                                     mass=state.mass)
    return State(x, y, xv, yv, xf, yf, state.mass, state.radius)


def run(cfg: SimConfig, state: State, steps: int) -> State:
    """Run ``steps`` simulation steps."""
    for _ in range(steps):
        state = step(cfg, state)
    return state
