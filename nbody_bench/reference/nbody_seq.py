"""The reference program's step and frame, in float64 plain PyTorch.

Written from the semantics of jfdev001/parallel-nbody's ``nbody-seq.c``:

- forces (``compute_forces``, :79-109): for every pair of distinct bodies,
  ``d2 = dx*dx + dy*dy``, ``forced = max(d2, (r_i + r_j)**2)``,
  ``force = G m_i m_j / forced``, along ``(cos, sin)(atan2(dy, dx))``, which
  is ``(dx, dy) / sqrt(d2)``; two distinct bodies at one position give
  ``atan2(0, 0) = 0``, a kick of ``force`` along +x on the lower index and
  along -x on the higher;
- velocities (:114-130): ``f -= |v| * FRICTION * (cos, sin)(atan2(yv, xv))``,
  ``v += f / m * dt``;
- positions (:135-165): ``x += v * dt`` with the new velocity; below 0 the
  position becomes 0, at or past the arena's edge ``dim - 1``, and the
  velocity component is negated;
- the frame (``display``, :326-354): each pixel takes the colour of the
  lowest-index body whose centre lies within ``radius + 0.5`` of it, the
  12-bit tint ``0xfff * (b + 1) / (n + 2)`` in RGB nibbles (:307-324), and
  black where none does.

Forces run in blocks of rows against all columns, so the (rows, n)
temporaries stay within ``BLOCK_ELEMS`` elements.  Every function also
returns the scales that the comparison needs: ``abs_force``, the sum of the
pair terms' magnitudes, ``G m_i sum_j m_j / forced``, which bounds what
rounding can do to a sum of these terms.
"""

from __future__ import annotations

import torch

# Elements of one (rows, n) float64 temporary: 256 MiB.
BLOCK_ELEMS = 1 << 25


def forces(x, y, mass, radius, gravity: float, rows=None):
    """(fx, fy, abs_force) of the bodies ``rows`` (an index tensor; all
    bodies when None) under all bodies.  Inputs are float64 tensors of one
    device."""
    n = x.shape[0]
    if rows is None:
        rows = torch.arange(n, device=x.device)
    block = max(1, BLOCK_ELEMS // n)
    out = [torch.empty(rows.shape[0], dtype=torch.float64, device=x.device)
           for _ in range(3)]
    cols = torch.arange(n, device=x.device)
    for b0 in range(0, rows.shape[0], block):
        ids = rows[b0:b0 + block]
        dx = x[None, :] - x[ids, None]
        dy = y[None, :] - y[ids, None]
        d2 = dx * dx
        d2.addcmul_(dy, dy)
        w = radius[None, :] + radius[ids, None]
        w.square_()
        torch.maximum(w, d2, out=w)
        w.reciprocal_().mul_(mass[None, :])  # m_j / forced
        coincide = d2 == 0
        coincide[torch.arange(ids.shape[0], device=x.device), ids] = False
        w_self = mass[ids] / (2.0 * radius[ids]) ** 2
        abs_sum = w.sum(1) - w_self
        # Direction (dx, dy) / d; at d2 == 0, dx = dy = 0 and the clamp
        # keeps the product finite (0), the kick is added below.
        d2.clamp_(min=1e-300).rsqrt_().mul_(w)
        fx = torch.einsum("ij,ij->i", d2, dx)
        fy = torch.einsum("ij,ij->i", d2, dy)
        hit = coincide.any(1).nonzero()[:, 0]
        if hit.numel():
            sign = torch.sign(cols[None, :] - ids[hit, None]).double()
            fx[hit] += (torch.where(coincide[hit], w[hit], 0.0)
                        * sign).sum(1)
        scale = gravity * mass[ids]
        for o, v in zip(out, (fx, fy, abs_sum)):
            o[b0:b0 + ids.shape[0]] = scale * v
    return tuple(out)


def velocities(xv, yv, fx, fy, mass, friction: float, dt: float):
    """(xv, yv) after ``compute_velocities``."""
    speed = torch.sqrt(xv * xv + yv * yv) * friction
    angle = torch.atan2(yv, xv)
    fx = fx - speed * torch.cos(angle)
    fy = fy - speed * torch.sin(angle)
    return xv + fx / mass * dt, yv + fy / mass * dt


def positions(x, xv, dim: int, dt: float):
    """(x, xv, unclamped) along one axis after ``compute_positions``;
    ``unclamped`` is ``x + xv * dt`` before the walls."""
    free = x + xv * dt
    low, high = free < 0, free >= dim
    new = torch.where(low, 0.0, torch.where(high, float(dim - 1), free))
    return new, torch.where(low | high, -xv, xv), free


def step(st, mass, radius, cfg, rows=None):
    """One step from ``st`` (a dict of float64 tensors x, y, xv, yv) with
    the configuration ``cfg`` (gravity, friction, dt, xdim, ydim), for the
    bodies ``rows`` (an index tensor; all bodies when None) under all
    bodies.  Returns a dict, over those bodies, with the forces,
    ``abs_force``, the new velocities and positions, and the unclamped
    positions."""
    fx, fy, abs_force = forces(st["x"], st["y"], mass, radius,
                               cfg["gravity"], rows)
    mine = {k: (v if rows is None else v[rows]) for k, v in st.items()}
    m = mass if rows is None else mass[rows]
    xv, yv = velocities(mine["xv"], mine["yv"], fx, fy, m, cfg["friction"],
                        cfg["dt"])
    x, xv, x_free = positions(mine["x"], xv, cfg["xdim"], cfg["dt"])
    y, yv, y_free = positions(mine["y"], yv, cfg["ydim"], cfg["dt"])
    return dict(xf=fx, yf=fy, abs_force=abs_force, xv=xv, yv=yv, x=x, y=y,
                x_free=x_free, y_free=y_free)


def frame(x, y, radius, xdim: int, ydim: int):
    """The (ydim, xdim, 3) uint8 frame of ``display``.  Each body tests the
    pixels of its bounding square, and every pixel keeps the lowest index
    that hits it; bodies go in groups of one square size, so the work is the
    sum of the squares, not pixels times bodies."""
    n = x.shape[0]
    device = x.device
    reach = radius + 0.5
    side = (2 * torch.ceil(reach) + 3).long()
    best = torch.full((ydim * xdim,), n, dtype=torch.int64, device=device)
    for s in torch.unique(side).tolist():
        ids = (side == s).nonzero()[:, 0]
        off = torch.arange(s, device=device) - s // 2
        step = max(1, BLOCK_ELEMS // (s * s))
        for b0 in range(0, ids.shape[0], step):
            b = ids[b0:b0 + step]
            px = torch.floor(x[b])[:, None, None] + off[None, None, :]
            py = torch.floor(y[b])[:, None, None] + off[None, :, None]
            dx = x[b, None, None] - px
            dy = y[b, None, None] - py
            hit = torch.sqrt(dx * dx + dy * dy) <= reach[b, None, None]
            hit &= (px >= 0) & (px < xdim) & (py >= 0) & (py < ydim)
            pix = (py * xdim + px).long()
            body = b[:, None, None].expand_as(pix)
            best.scatter_reduce_(0, pix[hit], body[hit], "amin")
    tint = (0xFFF * (best + 1)) // (n + 2)
    rgb = torch.stack([(tint & 0xF) << 4, tint & 0xF0, (tint & 0xF00) >> 4],
                      dim=-1)
    rgb[best == n] = 0
    return rgb.to(torch.uint8).reshape(ydim, xdim, 3)
