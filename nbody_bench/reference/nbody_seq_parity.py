"""The reference program's step in its parity mode, in float64 plain
PyTorch: ``nbody-seq.c``'s force loop with every body's sum built in the C
loop's own order.

Written from jfdev001/parallel-nbody's ``nbody-seq.c``:

- forces (``clear_forces`` then ``compute_forces``, :79-109): every force
  starts at zero, and the loop visits each pair ``i < j`` once, with
  ``dx = x[j] - x[i]``, ``dy = y[j] - y[i]``, ``angle = atan2(dy, dx)``,
  ``dsqr = dx*dx + dy*dy``, ``forced = max(dsqr, (r_i + r_j)**2)``,
  ``force = m_i * m_j * G / forced`` and ``(fx, fy) = force * (cos, sin)
  (angle)``, added to body i and subtracted from body j.  So body k meets
  its partners in ascending order, each term added onto its running sum
  one at a time: a partner j < k as the pair's higher index (``-``), a
  partner j > k as its lower (``+``).  Here each body's terms are formed
  from the pair as the C loop forms it, the lower index first, and added
  to the body's sum column by column in that order.  Two distinct bodies
  at one position give ``atan2(0, 0) = 0``: the kick ``force`` along +x
  on the lower index and along -x on the higher, with no case of its own;
- velocities and positions (:114-165): those of ``nbody_seq``, the same
  program's step, with ``v += f / m * dt``.

Every operation is one torch elementwise call, so each rounds once and
nothing is contracted.  The sums are the C program's; on the CPU, torch's
atan2 may round an argument differently from one position of a tensor to
another (its vectorised and scalar loops), which the card's elementwise
kernels do not.

Columns go in chunks, so the (rows, chunk) temporaries stay within
``BLOCK_ELEMS`` elements.  ``abs_force``, the sum of the pair terms'
magnitudes ``G m_i m_j / forced``, bounds what rounding can do to a sum of
them, for the comparison's scale.
"""

from __future__ import annotations

import torch

from . import nbody_seq

# Elements of one (rows, chunk) float64 temporary: 16 MiB.
BLOCK_ELEMS = 1 << 21


def forces(x, y, mass, radius, gravity: float, rows=None):
    """(fx, fy, abs_force) of the bodies ``rows`` (an index tensor; all
    bodies when None) under all bodies, each sum in the C loop's order.
    Inputs are float64 tensors of one device."""
    n = x.shape[0]
    if rows is None:
        rows = torch.arange(n, device=x.device)
    k = rows[:, None]
    fx = torch.zeros(rows.shape[0], dtype=torch.float64, device=x.device)
    fy = torch.zeros_like(fx)
    abs_sum = torch.zeros_like(fx)
    chunk = max(1, BLOCK_ELEMS // max(rows.shape[0], 1))
    zero = torch.zeros((), dtype=torch.float64, device=x.device)
    for c0 in range(0, n, chunk):
        j = torch.arange(c0, min(n, c0 + chunk), device=x.device)[None, :]
        cols = j[0]
        upper = j > k  # body k is the pair's lower index
        xk, yk, xj, yj = x[rows, None], y[rows, None], x[None, cols], \
            y[None, cols]
        dx = torch.where(upper, xj - xk, xk - xj)
        dy = torch.where(upper, yj - yk, yk - yj)
        angle = torch.atan2(dy, dx)
        dsqr = dx * dx + dy * dy
        mind = radius[rows, None] + radius[None, cols]
        forced = torch.maximum(dsqr, mind * mind)
        force = mass[rows, None] * mass[None, cols] * gravity / forced
        other = j != k
        tx = torch.where(other, torch.where(upper, 1.0, -1.0), 0.0) \
            * (force * torch.cos(angle))
        ty = torch.where(other, torch.where(upper, 1.0, -1.0), 0.0) \
            * (force * torch.sin(angle))
        abs_sum += torch.where(other, force, zero).sum(1)
        # One add per partner, in ascending order.
        for cx, cy in zip(tx.t().contiguous(), ty.t().contiguous()):
            fx += cx
            fy += cy
    return fx, fy, abs_sum


def step(st, mass, radius, cfg, rows=None):
    """One step from ``st`` (a dict of float64 tensors x, y, xv, yv) with
    the configuration ``cfg`` (gravity, friction, dt, xdim, ydim), for the
    bodies ``rows`` (an index tensor; all bodies when None) under all
    bodies.  Returns a dict, over those bodies, with the forces,
    ``abs_force``, the new velocities and positions, and the unclamped
    positions (``nbody_seq.step``'s keys)."""
    fx, fy, abs_force = forces(st["x"], st["y"], mass, radius,
                               cfg["gravity"], rows)
    mine = {k: (v if rows is None else v[rows]) for k, v in st.items()}
    m = mass if rows is None else mass[rows]
    xv, yv = nbody_seq.velocities(mine["xv"], mine["yv"], fx, fy, m,
                                  cfg["friction"], cfg["dt"])
    x, xv, x_free = nbody_seq.positions(mine["x"], xv, cfg["xdim"],
                                        cfg["dt"])
    y, yv, y_free = nbody_seq.positions(mine["y"], yv, cfg["ydim"],
                                        cfg["dt"])
    return dict(xf=fx, yf=fy, abs_force=abs_force, xv=xv, yv=yv, x=x, y=y,
                x_free=x_free, y_free=y_free)
