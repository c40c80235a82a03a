"""``state.random_state``'s law: positions uniform over the arena,
velocities uniform in [-5, 5), the reference's radius and mass law.  The
draws come from a CPU ``torch.Generator`` seeded with ``--seed``, in float64
and in the order x, y, xv, yv, so the same seed gives the same bodies on
any machine.  No two bodies coincide (the chance is about n**2 / 2**49)."""

from __future__ import annotations

import torch

from . import radius_mass


def make(n: int, xdim: int, ydim: int, seed: int):
    gen = torch.Generator().manual_seed(seed % (1 << 63))

    def uniform(lo, hi):
        u = torch.rand(n, generator=gen, dtype=torch.float64)
        return (lo + (hi - lo) * u).numpy()

    x = uniform(0.0, xdim)
    y = uniform(0.0, ydim)
    xv = uniform(-5.0, 5.0)
    yv = uniform(-5.0, 5.0)
    mass, radius = radius_mass(n, xdim, ydim)
    return x, y, xv, yv, mass, radius
