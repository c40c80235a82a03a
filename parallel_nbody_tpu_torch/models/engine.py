"""Single-device simulation engine.

The reference's hot loop (nbody-seq.c:457-472) is
``clear_forces -> compute_forces -> compute_velocities -> compute_positions``
with a buffer flip.  Here ``run`` is a Python loop of ``step``, each step a
sequence of eager tensor ops on the state's device; with ``kernel="cuda"``
the force pass is one call of a hand-written kernel (K1, or K2 above 131072
bodies, in several row launches past K2's workspace bound; in the parity
mode, ``force_mode="trig"`` in float64, the parity pass at any N;
ops/cuda_step.cuda_forces).  Nothing in the
loop reads a value back to the host, so on a GPU the launches queue without
waiting for the device (the NaN-check debug mode of ``run`` aside).

``make_hosted_row_step`` is the step with the force pass through K2 in row
launches of a chunk the caller sets, at any N.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..ops import _build
from ..ops.cuda_step import (cuda_forces, forces_coincident_dispatch,
                             streamed_forces)
from ..ops.forces import compute_forces_dense
from ..ops.integrate import compute_positions, compute_velocities
from ..state import State
from ..utils.debug import check_finite
from ..utils.timing import span


def step(cfg: SimConfig, state: State) -> State:
    """One simulation step (force -> velocity -> position), the span
    ``nbody.step``: every operation it launches lies under one of its
    children ``nbody.coincident``, ``nbody.forces`` or ``nbody.integrate``
    (``utils.timing.span``)."""
    with span("nbody.step"):
        if cfg.kernel == "cuda" and cfg.force_mode == "fast":
            # The coincidence flag stays on the device: the kernel reads it
            # and adds the reference's atan2(0,0) kick (nbody-seq.c:91-106)
            # only on steps that hold coincident distinct bodies.
            xf, yf = forces_coincident_dispatch(
                state.x, state.y, state.mass,
                lambda biased: cuda_forces(cfg, state.x, state.y,
                                           state.mass, state.radius,
                                           biased=biased, accum=cfg.accum))
        else:
            # The trig formula makes that kick by itself, so the parity
            # pass, like the dense path, runs no coincidence flag.
            with span("nbody.forces"):
                if cfg.kernel == "cuda":
                    xf, yf = cuda_forces(cfg, state.x, state.y, state.mass,
                                         state.radius, biased=False)
                else:
                    xf, yf = compute_forces_dense(cfg, state.x, state.y,
                                                  state.mass, state.radius)
        return _integrate(cfg, state, xf, yf)


def _integrate(cfg: SimConfig, state: State, xf, yf) -> State:
    """Velocity and position integration of ``state`` under forces
    (xf, yf), the span ``nbody.integrate``."""
    with span("nbody.integrate"):
        xv, yv = compute_velocities(cfg, state.xv, state.yv, xf, yf,
                                    state.mass)
        x, y, xv, yv = compute_positions(cfg, state.x, state.y, xv, yv,
                                         mass=state.mass)
    return State(x, y, xv, yv, xf, yf, state.mass, state.radius)


def make_hosted_row_step(cfg: SimConfig, n: int, row_chunk: int = 524288):
    """``step`` of ``n`` bodies with the force pass through K2 in launches
    of ``row_chunk`` rows at any ``n`` (``cuda_step.streamed_forces``): the
    counterpart of the JAX package's ``make_hosted_row_step``, for a caller
    that sets the chunk itself, as ``benchmarks/huge_n`` does.  ``step``
    runs K2 only above 131072 bodies, in launches sized by
    ``cuda_step.K2_WORKSPACE_BYTES``.  The chunks bound K2's workspace; a
    CUDA launch has no time limit (the JAX package's chunks also keep each
    TPU dispatch short).  ``any_coincident`` runs once a step, and its 0-d
    device flag goes to every launch unread by the host.

    Returns (step_fn, warmup): ``step_fn(state, fence=None) -> State``
    calls ``fence(xf)`` after each launch when given; ``warmup()`` builds
    and loads the kernel library and runs no step.  On CPU tensors each
    launch is K2's plain version.
    """

    if cfg.force_mode != "fast":
        raise ValueError("make_hosted_row_step: the row launches are K2's, "
                         "force_mode='fast' only; the parity mode steps "
                         "through step() at any N")

    def step_fn(state: State, fence=None) -> State:
        if state.x.shape[0] != n:
            raise ValueError("make_hosted_row_step: a step of %d bodies got "
                             "%d" % (n, state.x.shape[0]))
        with span("nbody.step"):
            xf, yf = forces_coincident_dispatch(
                state.x, state.y, state.mass,
                lambda biased: streamed_forces(
                    cfg, state.x, state.y, state.mass, state.radius,
                    biased=biased, accum=cfg.accum, row_chunk=row_chunk,
                    fence=fence))
            return _integrate(cfg, state, xf, yf)

    return step_fn, _build.load


def run(cfg: SimConfig, state: State, steps: int,
        nan_check_from: int | None = None) -> State:
    """Run ``steps`` simulation steps.

    ``nan_check_from`` turns on the NaN-check debug mode: it is the number
    of steps the state has already taken, and every step's output is then
    read back and checked (``utils.debug.check_finite``), so the first
    non-finite value raises FloatingPointError naming its field and step.
    """
    for i in range(steps):
        state = step(cfg, state)
        if nan_check_from is not None:
            check_finite(state, nan_check_from + i + 1)
    return state


def run_trajectory(cfg: SimConfig, state: State, steps: int,
                   record_every: int = 1):
    """Run ``steps`` steps, recording (x, y) every ``record_every`` steps.

    Returns (final_state, xs, ys) where xs/ys have shape
    (steps // record_every, N); as in the JAX package, the steps past the
    last record are not run.  Used for animation / analysis.
    """
    records = steps // record_every
    xs = state.x.new_empty((records, state.n))
    ys = state.y.new_empty((records, state.n))
    for i in range(records):
        state = run(cfg, state, record_every)
        xs[i], ys[i] = state.x, state.y
    return state, xs, ys


def total_energy(cfg: SimConfig, state: State) -> torch.Tensor:
    """Diagnostic: kinetic + (softened) potential energy, a 0-d tensor.

    The reference has no energy accounting; this supports the long-run drift
    regression.  Uses the same softened denominator as the force law
    (potential consistent with F = -G m_i m_j / max(d^2, mind^2) along the
    pair axis).  Materializes the (N, N) pair matrix.
    """
    ke = 0.5 * torch.sum(state.mass * (state.xv**2 + state.yv**2))
    dx = state.x[None, :] - state.x[:, None]
    dy = state.y[None, :] - state.y[:, None]
    dsqr = dx * dx + dy * dy
    mind = state.radius[:, None] + state.radius[None, :]
    d = torch.sqrt(torch.maximum(dsqr, mind * mind).clamp(min=1e-30))
    pair_pe = -cfg.gravity * state.mass[:, None] * state.mass[None, :] / d
    return ke + torch.sum(torch.triu(pair_pe, diagonal=1))
