"""Velocity / position update (semi-implicit order) with friction and wall
bounce.

Reference semantics:
  - compute_velocities (nbody-seq.c:114-130): speed-proportional drag
    ``|v| * FRICTION`` applied opposite ``atan2(yv, xv)``, then
    ``v += (f / m) * dt``.
  - compute_positions (nbody-seq.c:135-165): ``x_new = x + v_new * dt`` using
    the JUST-updated velocity; wall bounce clamps to ``0`` (low) or
    ``dim - 1`` (high, asymmetric!) and negates the velocity component.

``mode="trig"`` keeps the reference's ``cos(atan2(yv, xv))`` drag projection
for parity.  ``mode="fast"`` uses the identity
``|v| * cos(atan2(yv, xv)) == xv`` so drag is simply ``FRICTION * v``.
"""

from __future__ import annotations

import torch

from ..config import SimConfig


def compute_velocities(cfg: SimConfig, xv, yv, xf, yf, mass):
    if cfg.force_mode == "trig":
        speed = torch.sqrt(xv * xv + yv * yv) * cfg.friction
        angle = torch.atan2(yv, xv)
        fx = xf - speed * torch.cos(angle)
        fy = yf - speed * torch.sin(angle)
    else:
        fx = xf - cfg.friction * xv
        fy = yf - cfg.friction * yv
    # Zero-mass padding bodies (pad_state) must stay inert: guard the 1/m.
    inv_m = torch.where(mass > 0, 1.0 / mass, torch.zeros_like(mass))
    return xv + fx * inv_m * cfg.dt, yv + fy * inv_m * cfg.dt


def compute_positions(cfg: SimConfig, x, y, xv, yv, mass=None):
    """Returns (x_new, y_new, xv_new, yv_new) after the wall bounce.

    Pass ``mass`` on padded states (pad_state): zero-mass padding rows are
    frozen in place, so the wall clamp never drags the far-away padding
    into the arena.  For unpadded states the select is a no-op.

    The high wall clamps to ``dim - 1`` rounded to the state's dtype, as the
    JAX package does.  In bfloat16 that is 1024 for 1023 and 768 for 767,
    so a bouncing body sits on ``dim`` itself: a defect of the reference
    that the port keeps on purpose, since the JAX package is what it is
    held against (tests/test_torch_ops.py::test_bf16_high_wall_clamp).
    """
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    xn = x + xv * cfg.dt
    yn = y + yv * cfg.dt

    lo_x = xn < 0
    hi_x = xn >= cfg.xdim
    xn = torch.where(lo_x, zero, torch.where(hi_x, zero + (cfg.xdim - 1), xn))
    xvn = torch.where(lo_x | hi_x, -xv, xv)

    lo_y = yn < 0
    hi_y = yn >= cfg.ydim
    yn = torch.where(lo_y, zero, torch.where(hi_y, zero + (cfg.ydim - 1), yn))
    yvn = torch.where(lo_y | hi_y, -yv, yv)

    if mass is not None:
        real = mass > 0
        xn = torch.where(real, xn, x)
        yn = torch.where(real, yn, y)
        xvn = torch.where(real, xvn, xv)
        yvn = torch.where(real, yvn, yv)

    return xn, yn, xvn, yvn
