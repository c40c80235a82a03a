"""Initial states made from ``--seed``, one module per law.

Each law is a frozen copy, so a later change to the port's own init code
never changes the benchmark's inputs.  ``make(mix, n, xdim, ydim, seed)``
reads a traffic mix's parameters: ``init``, the law (a module of this
package); ``law_seed``, a fixed seed for the law (null: ``--seed``); and
``relabel``, whether ``--seed`` draws a permutation of the bodies' indices.
It returns float64 host arrays (x, y, xv, yv, mass, radius); the harness
rounds them once to the configuration's dtype and hands the same values to
the program and to the reference.
"""

from __future__ import annotations

import importlib
import math

import numpy as np
import torch


def radius_mass(n: int, xdim: int, ydim: int):
    """The reference's radius and mass law (nbody-seq.c:444-447), shared by
    both laws: ``radius = 1 + (b*b + 1) * diag / (25 * (n*n + 1))``,
    ``mass = radius**3``, in float64."""
    b = np.arange(n, dtype=np.float64)
    diag = math.sqrt(1.0 * (xdim * xdim + ydim * ydim))
    radius = 1.0 + ((b * b + 1.0) * diag) / (25.0 * (n * n + 1.0))
    return radius * radius * radius, radius


def make(mix: dict, n: int, xdim: int, ydim: int, seed: int):
    """(x, y, xv, yv, mass, radius) of the mix's law from ``seed``, as
    float64 numpy arrays.  With ``relabel``, the same bodies come in the
    order of a permutation drawn from ``seed`` (each body keeps its own
    mass and radius)."""
    module = importlib.import_module("%s.%s" % (__name__, mix["init"]))
    law_seed = mix.get("law_seed")
    arrays = module.make(n, xdim, ydim, seed if law_seed is None else law_seed)
    if not mix.get("relabel"):
        return arrays
    gen = torch.Generator().manual_seed(seed % (1 << 63))
    perm = torch.randperm(n, generator=gen).numpy()
    return tuple(a[perm] for a in arrays)
