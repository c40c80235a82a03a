"""Simulation state as a structure of 1-D tensors.

The reference stores bodies as a double-buffered array-of-structs
(``struct bodyType`` with ``x[2]/y[2]``, nbody/nbody-seq.c:30-50) and flips an
``old`` bit each step.  Here each field is one ``(N,)`` tensor on the run's
device; a step returns a new ``State`` (the buffer flip disappears).

Forces are carried in the state even though they are recomputed every step,
because the reference's output contract prints the final step's forces
(nbody/nbody-seq.c:356-365).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import SEED, SimConfig
from .utils import glibc_rand


class State(NamedTuple):
    """SoA body state.  All tensors have shape ``(N,)``, one dtype and one
    device."""

    x: torch.Tensor
    y: torch.Tensor
    xv: torch.Tensor
    yv: torch.Tensor
    xf: torch.Tensor
    yf: torch.Tensor
    mass: torch.Tensor
    radius: torch.Tensor

    @property
    def n(self) -> int:
        return self.x.shape[0]


def _checked_cast(arr: np.ndarray, dtype: torch.dtype,
                  name: str) -> torch.Tensor:
    """Cast a finite float64 init array to the run dtype, failing LOUDLY if
    the cast overflows to inf (a run whose inputs are already non-finite can
    only print NaNs with exit code 0)."""
    src = torch.from_numpy(np.asarray(arr, dtype=np.float64))
    out = src.to(dtype)
    bad = ~torch.isfinite(out) & torch.isfinite(src)
    if bool(bad.any()):
        i = int(torch.argmax(bad.to(torch.uint8)))
        raise ValueError(
            "initial %s[%d] = %r overflows dtype %s (finite max %r); this "
            "dtype cannot represent the reference init law at this N/arena "
            "— use a wider dtype" % (name, i, float(arr[i]), dtype,
                                     torch.finfo(dtype).max))
    return out


def init_state(n: int, cfg: SimConfig, seed: int = SEED,
               device: torch.device | str = "cpu") -> State:
    """Reference-parity initialization (glibc rand replica; see
    utils/glibc_rand.py and nbody/nbody-seq.c:440-449), built on the host
    and moved to ``device`` once."""
    x, y, xv, yv, mass, radius = glibc_rand.nbody_init_arrays(
        n, cfg.xdim, cfg.ydim, seed)
    dtype = cfg.torch_dtype
    zeros = np.zeros(n, dtype=np.float64)
    fields = (x, y, xv, yv, zeros, zeros, mass, radius)
    return State(*(_checked_cast(a, dtype, name).to(device)
                   for a, name in zip(fields, State._fields)))


def random_state(n: int, cfg: SimConfig, generator: torch.Generator,
                 device: torch.device | str = "cpu") -> State:
    """Fast non-parity initialization from a ``torch.Generator`` (benchmarks
    and large-N runs where glibc parity is irrelevant): uniform positions
    and velocities, the reference's radius/mass law.  Numbers are drawn on
    the generator's device and then moved to ``device``."""
    dtype = cfg.torch_dtype

    def uniform(lo, hi):
        u = torch.rand(n, generator=generator, dtype=dtype,
                       device=generator.device)
        return (lo + (hi - lo) * u).to(device)

    x = uniform(0.0, cfg.xdim)
    y = uniform(0.0, cfg.ydim)
    xv = uniform(-5.0, 5.0)
    yv = uniform(-5.0, 5.0)
    b = torch.arange(n, dtype=dtype, device=device)
    diag = torch.sqrt(torch.tensor(cfg.xdim**2 + cfg.ydim**2, dtype=dtype,
                                   device=device))
    radius = 1.0 + ((b * b + 1.0) * diag) / (25.0 * (n * n + 1.0))
    mass = radius**3
    zeros = torch.zeros(n, dtype=dtype, device=device)
    return State(x, y, xv, yv, zeros, zeros.clone(), mass, radius)


def pad_state(state: State, multiple: int) -> tuple[State, int]:
    """Pad the body axis up to a multiple.

    Padding bodies get zero mass (so they exert no force), zero velocity, and
    positions far outside the arena so softening never couples them to real
    bodies.  Returns (padded_state, original_n).
    """
    n = state.n
    rem = (-n) % multiple
    if rem == 0:
        return state, n

    def pad(a, fill):
        return torch.cat([a, torch.full((rem,), fill, dtype=a.dtype,
                                        device=a.device)])

    fills = dict(x=1e9, y=1e9, xv=0.0, yv=0.0, xf=0.0, yf=0.0, mass=0.0,
                 radius=0.0)
    return State(*(pad(a, fills[f]) for a, f in zip(state, State._fields))), n


def unpad_state(state: State, n: int) -> State:
    if state.n == n:
        return state
    return State(*(a[:n] for a in state))
