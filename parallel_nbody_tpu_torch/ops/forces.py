"""Pairwise gravitational forces (dense formulation).

Physics contract (reference: nbody/nbody-seq.c:79-109):

  for each unordered pair (i, j), i < j:
      dx     = x[j] - x[i]
      dy     = y[j] - y[i]
      angle  = atan2(dy, dx)
      dsqr   = dx^2 + dy^2
      forced = max(dsqr, (r_i + r_j)^2)         # plummer-less softening
      force  = m_i * m_j * G / forced
      fx     = force * cos(angle)               # trig decomposition — parity-
      fy     = force * sin(angle)               # sensitive (NOT dx/|d|)
      F[i] += (fx, fy);  F[j] -= (fx, fy)       # Newton's 3rd law

Coincident-pair semantics: two DISTINCT bodies at the same position give
``angle = atan2(0, 0) = 0``, so the reference exerts a separating kick
``force * (1, 0)`` — the smaller-index body gets ``+x``, the larger ``-x``
(nbody-seq.c:91,97-106).  The glibc init places bodies on integer pixels, so
at N=4096 the initial state already holds 15 such pairs.  The fast path
reproduces it as ``fx += sign(gj - gi) * force`` by global body index;
self-pairs (gi == gj) and zero-mass padding stay at zero.

The dense op materializes the (N, N) pair matrix once per step.  The
hand-written CUDA kernel in ops/cuda_step.py computes the fast path without
it.

``mode="trig"`` keeps the reference's transcendental decomposition and the
upper-triangle +/- accumulation (pair values computed once, exactly like the
C loop).  ``mode="fast"`` uses ``force * dx * rsqrt(dsqr)`` over the full
(i != j) matrix, so each row sums independently.
"""

from __future__ import annotations

import torch

from ..config import SimConfig

# Clamp for the softened denominator.  Real bodies always have
# (r_i + r_j)^2 >= 4 (radius >= 1, nbody-seq.c:444), so this only guards
# zero-mass padding bodies from producing 0/0 = NaN.
_DENOM_FLOOR = 1e-30


def pair_forces_trig(cfg: SimConfig, x, y, mass, radius):
    """Upper-triangle pair force matrix with the reference's trig math.

    Returns (fx, fy) where entry [i, j] (i < j) is the force of j on i along
    +x/+y; entries with i >= j are zero.  Coincident pairs need no special
    case: atan2(0, 0) == 0 gives fx = force, fy = 0 exactly as in the
    reference, and the +/- triangle accumulation applies the signs.
    """
    dx = x[None, :] - x[:, None]
    dy = y[None, :] - y[:, None]
    angle = torch.atan2(dy, dx)
    dsqr = dx * dx + dy * dy
    mind = radius[:, None] + radius[None, :]
    forced = torch.clamp_min(torch.maximum(dsqr, mind * mind), _DENOM_FLOOR)
    force = mass[:, None] * mass[None, :] * cfg.gravity / forced
    fx = force * torch.cos(angle)
    fy = force * torch.sin(angle)
    upper = torch.ones_like(fx, dtype=torch.bool).triu(1)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(upper, fx, zero), torch.where(upper, fy, zero)


def _sequential_row_sum(s):
    """Left-to-right sequential row sums of a 2-D matrix (shape (N, N) ->
    (N,)), replicating the C program's per-body accumulation order exactly.

    The reference walks pairs lexicographically, so body k's force receives
    contributions in column order j = 0..N-1.  A tree reduction
    (``torch.sum``) gives the same value up to rounding, but at large N the
    different rounding shows in the 3-decimal print.  A loop over columns is
    sequential by construction, in the tensor's own dtype, on any device
    (``torch.cumsum`` is a parallel scan on CUDA, and accumulates float32 in
    double on the CPU).
    """
    cols = s.t().contiguous()
    total = torch.zeros_like(cols[0])
    for col in cols:
        total += col
    return total


def compute_forces_dense(cfg: SimConfig, x, y, mass, radius):
    """Total force on every body, dense O(N^2).

    Returns (xf, yf) with shape (N,).
    """
    if cfg.force_mode == "trig":
        fx, fy = pair_forces_trig(cfg, x, y, mass, radius)
        # Pair value computed once per (i<j), applied +/- to both owners —
        # mirrors the C accumulation (nbody-seq.c:103-106).  The signed
        # matrix fx - fx.T is exact (entries are fx[i,j], -fx[j,i], or 0);
        # the sequential row sum then replicates the C loop's accumulation
        # order bit for bit, not just its value.
        xf = _sequential_row_sum(fx - fx.T)
        yf = _sequential_row_sum(fy - fy.T)
        return xf, yf
    return _forces_fast_block(cfg, x, y, mass, x, y, mass, radius, radius,
                              0, 0)


def _pair_sign(dtype, device, ni, nj, gi0, gj0):
    """sign(gj - gi) over the (ni, nj) pair block — 0 exactly on self-pairs.
    ``gi0``/``gj0`` are the blocks' global starting body indices."""
    gi = gi0 + torch.arange(ni, device=device)
    gj = gj0 + torch.arange(nj, device=device)
    return torch.sign(gj[None, :] - gi[:, None]).to(dtype)


def _forces_fast_block(cfg, xi, yi, mi, xj, yj, mj, ri, rj, gi0, gj0):
    """Fast-path force of every body in block J on every body in block I.

    One-sided accumulation (each row block computes its own forces over all
    columns).  ``gi0``/``gj0`` are the blocks' global starting body indices:
    self-pairs are wherever gi0+i == gj0+j, and coincident distinct pairs get
    the reference's sign(gj - gi) * force kick along +x.
    """
    dtype = xi.dtype
    zero = torch.zeros((), dtype=dtype, device=xi.device)
    dx = xj[None, :] - xi[:, None]
    dy = yj[None, :] - yi[:, None]
    dsqr = dx * dx + dy * dy
    mind = ri[:, None] + rj[None, :]
    forced = torch.clamp_min(torch.maximum(dsqr, mind * mind), _DENOM_FLOOR)
    base = mi[:, None] * mj[None, :] * cfg.gravity / forced
    # Direction = unit vector of (dx, dy): cos(atan2(dy,dx)) == dx * rsqrt(dsqr).
    inv_r = torch.where(dsqr > 0, torch.rsqrt(torch.clamp_min(dsqr,
                                                              _DENOM_FLOOR)),
                        zero)
    scale = base * inv_r
    # Coincident pairs: scale * dx == 0 there, so add the atan2(0,0)-limit
    # kick.  sign(gj - gi) is 0 exactly on self-pairs, masking them for free;
    # zero-mass padding keeps base == 0.
    ni, nj = dx.shape
    sgn = _pair_sign(dtype, xi.device, ni, nj, gi0, gj0)
    coin = dsqr == 0
    fx = scale * dx + torch.where(coin, base * sgn, zero)
    return torch.sum(fx, dim=1), torch.sum(scale * dy, dim=1)
