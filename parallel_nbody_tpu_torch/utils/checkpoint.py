"""Checkpoint / resume (.npz state snapshots).

The reference has none — its only persistence is the final stdout dump.
This is the JAX package's exact host snapshot: positions, velocities, forces,
masses, radii as float64 and the step counter as int64, in one ``.npz``.  The
layout is the JAX package's, so a file written by either package resumes
under the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..state import State


def save_state(path: str, state: State, step: int) -> None:
    arrays = {f: getattr(state, f).detach().to(
        device="cpu", dtype=torch.float64).numpy() for f in State._fields}
    np.savez(path, step=np.int64(step), **arrays)


def load_state(path: str, device: torch.device | str,
               dtype: torch.dtype) -> tuple[State, int]:
    """The snapshot's state on ``device`` in ``dtype`` (the run's, from its
    config), and its step counter."""
    with np.load(path) as z:
        state = State(*(torch.from_numpy(z[f]).to(device=device, dtype=dtype)
                        for f in State._fields))
        return state, int(z["step"])
