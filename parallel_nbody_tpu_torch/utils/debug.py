"""Debug / validation utilities.

The reference has no sanitizers.  The failure modes here are numerical
(NaN/Inf from bad softening or overflow); this module provides the NaN-check
debug mode behind ``--check-nans`` and the reference's per-field printers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..state import State


@dataclasses.dataclass
class StateDiagnostics:
    n: int
    finite: bool
    nan_fields: list[str]
    pos_in_bounds: bool
    max_speed: float
    max_force: float

    def ok(self) -> bool:
        return self.finite


def nonfinite_fields(state: State) -> list[str]:
    """Names of the state's fields that hold a NaN or an infinity (one host
    read per field)."""
    return [name for name, t in zip(State._fields, state)
            if not bool(torch.isfinite(t).all())]


def check_finite(state: State, step: int) -> None:
    """PyTorch has no global counterpart of ``jax_debug_nans``: under
    ``--check-nans`` the engine calls this after every step.  Raises
    FloatingPointError naming the fields and the step."""
    bad = nonfinite_fields(state)
    if bad:
        raise FloatingPointError("non-finite values in %s after step %d"
                                 % (",".join(bad), step))


def _format_pair(a: torch.Tensor, b: torch.Tensor) -> str:
    """Two-column %10.3f rendering shared by the per-field printers."""
    a = a.detach().to(device="cpu", dtype=torch.float64).numpy()
    b = b.detach().to(device="cpu", dtype=torch.float64).numpy()
    return "".join("%10.3f %10.3f\n" % (a[i], b[i]) for i in range(a.shape[0]))


def format_forces(state: State) -> str:
    """Per-body force printout (reference print_forces, nbody-par.c:708-717)."""
    return _format_pair(state.xf, state.yf)


def format_velocities(state: State) -> str:
    """Per-body velocity printout (reference print_velocities,
    nbody-par.c:719-728)."""
    return _format_pair(state.xv, state.yv)


def format_positions(state: State) -> str:
    """Per-body position printout (reference print_positions,
    nbody-par.c:730-739)."""
    return _format_pair(state.x, state.y)


def _max_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    norm = torch.sqrt(a ** 2 + b ** 2)
    return float(norm.max()) if norm.numel() else 0.0


def validate_state(state: State, xdim: int | None = None,
                   ydim: int | None = None) -> StateDiagnostics:
    """State validation (finiteness, bounds, magnitudes), computed on the
    state's device in its dtype; only the verdicts come to the host."""
    nan_fields = nonfinite_fields(state)
    in_bounds = True
    if xdim is not None:
        # Legal positions occupy [0, dim): the wall bounce clamps to dim-1
        # only once x_new >= dim (compute_positions), so e.g. x = xdim-0.5
        # is a healthy in-bounds state.
        x, y = state.x, state.y
        in_bounds = bool(((x >= 0) & (x < xdim) & (y >= 0) & (y < ydim)).all())
    return StateDiagnostics(
        n=state.n,
        finite=not nan_fields,
        nan_fields=nan_fields,
        pos_in_bounds=in_bounds,
        max_speed=_max_norm(state.xv, state.yv),
        max_force=_max_norm(state.xf, state.yf),
    )
