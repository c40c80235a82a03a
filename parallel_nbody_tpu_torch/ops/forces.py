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
it.  The block functions (``forces_block_vs_full``, ``forces_on_block``, and
``_trig_cross_block`` / ``_forces_fast_block`` with explicit global ids) are
the dense paths of the sharded programs in ``parallel/``.

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


def _pair_sign(dtype, device, ni, nj, gi0, gj0, gids=None):
    """sign(gj - gi) over the (ni, nj) pair block — 0 exactly on self-pairs.

    Global ids come either from the blocks' contiguous starting indices
    ``gi0``/``gj0`` or, when ``gids=(gi_vec, gj_vec)`` is given, from
    explicit per-body id tensors (the grid's col group is STRIDED, one chunk
    per mesh row, so offsets cannot describe it)."""
    if gids is not None:
        gi, gj = gids
    else:
        gi = gi0 + torch.arange(ni, device=device)
        gj = gj0 + torch.arange(nj, device=device)
    return torch.sign(gj[None, :] - gi[:, None]).to(dtype)


def _forces_fast_block(cfg, xi, yi, mi, xj, yj, mj, ri, rj, gi0, gj0,
                       gids=None):
    """Fast-path force of every body in block J on every body in block I.

    One-sided accumulation (each row block computes its own forces over all
    columns), the cross-block redundancy model of nbody-par.c:302-308.
    ``gi0``/``gj0`` are the blocks' global starting body indices: self-pairs
    are wherever gi0+i == gj0+j, and coincident distinct pairs get the
    reference's sign(gj - gi) * force kick along +x.  ``gids`` overrides the
    contiguous ids (see _pair_sign).
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
    sgn = _pair_sign(dtype, xi.device, ni, nj, gi0, gj0, gids)
    coin = dsqr == 0
    fx = scale * dx + torch.where(coin, base * sgn, zero)
    return torch.sum(fx, dim=1), torch.sum(scale * dy, dim=1)


def _trig_cross_block(cfg, xi, yi, mi, ri, xj, yj, mj, rj, gi0, gj0,
                      force_mask=None, gids=None):
    """One-sided trig force of column block J on row block I (cross-block
    pairs of the sharded decomposition; nbody-par.c:302-308 analog).

    Applies the reference's coincident semantics by GLOBAL index (the
    reference's own par binary diverges from seq here; this follows seq).
    ``force_mask`` (bool, (ni, nj)) optionally zeroes pair forces (used to
    drop own-block columns handled by the triangle); ``gids`` overrides the
    contiguous global ids (see _pair_sign).
    """
    dtype = xi.dtype
    zero = torch.zeros((), dtype=dtype, device=xi.device)
    dx = xj[None, :] - xi[:, None]
    dy = yj[None, :] - yi[:, None]
    angle = torch.atan2(dy, dx)
    dsqr = dx * dx + dy * dy
    mind = ri[:, None] + rj[None, :]
    forced = torch.clamp_min(torch.maximum(dsqr, mind * mind), _DENOM_FLOOR)
    force = mi[:, None] * mj[None, :] * cfg.gravity / forced
    if force_mask is not None:
        force = torch.where(force_mask, zero, force)
    ni, nj = dx.shape
    sgn = _pair_sign(dtype, xi.device, ni, nj, gi0, gj0, gids)
    coin = dsqr == 0  # includes self-pairs; sgn == 0 there
    fx = torch.where(coin, force * sgn, force * torch.cos(angle))
    fy = torch.where(coin, zero, force * torch.sin(angle))
    return torch.sum(fx, dim=1), torch.sum(fy, dim=1)


def forces_block_vs_full(cfg: SimConfig, x_blk, y_blk, m_blk, r_blk,
                         x_full, y_full, m_full, r_full, blk_offset: int):
    """Force on an owned body block from ALL bodies (gathered full arrays).

    The sharded analog of nbody-par.c:285-359: the owned block's internal
    pairs use the once-per-pair triangle accumulation (parity with the
    sequential program), while owned-vs-remote pairs are one-sided.
    ``blk_offset`` is the block's global starting index.

    In "fast" mode the whole thing is a single one-sided pass (self-pairs
    and coincident pairs handled by global index inside _forces_fast_block).
    """
    shard = x_blk.shape[0]
    n = x_full.shape[0]

    if cfg.force_mode == "trig":
        cols = torch.arange(n, device=x_blk.device).expand(shard, n)
        own = (cols >= blk_offset) & (cols < blk_offset + shard)
        xf, yf = _trig_cross_block(cfg, x_blk, y_blk, m_blk, r_blk,
                                   x_full, y_full, m_full, r_full,
                                   blk_offset, 0, force_mask=own)
        fx, fy = pair_forces_trig(cfg, x_blk, y_blk, m_blk, r_blk)
        return (xf + torch.sum(fx, dim=1) - torch.sum(fx, dim=0),
                yf + torch.sum(fy, dim=1) - torch.sum(fy, dim=0))

    return _forces_fast_block(cfg, x_blk, y_blk, m_blk,
                              x_full, y_full, m_full, r_blk, r_full,
                              blk_offset, 0)


def forces_on_block(cfg: SimConfig, xi, yi, mi, ri, xj, yj, mj, rj,
                    same_block: bool, gi0: int = 0, gj0: int = 0):
    """Block-on-block force (the ring's per-hop computation).

    ``gi0``/``gj0``: global starting indices of the two blocks (needed for
    self-pair masking and coincident-pair signs when the blocks overlap or
    contain coincident bodies).  ``same_block`` (block J is block I) takes
    the once-per-pair triangle in trig mode.
    """
    if cfg.force_mode == "trig" and same_block:
        fx, fy = pair_forces_trig(cfg, xi, yi, mi, ri)
        return torch.sum(fx, dim=1) - torch.sum(fx, dim=0), \
            torch.sum(fy, dim=1) - torch.sum(fy, dim=0)
    if cfg.force_mode == "trig":
        return _trig_cross_block(cfg, xi, yi, mi, ri, xj, yj, mj, rj,
                                 gi0, gj0)
    return _forces_fast_block(cfg, xi, yi, mi, xj, yj, mj, ri, rj, gi0, gj0)
