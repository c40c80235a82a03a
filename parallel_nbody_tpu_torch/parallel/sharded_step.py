"""The 1-D body decomposition over a mesh of ranks.

The reference's MPI layer (nbody-par.c), as the JAX package maps it:

  MPI_Bcast of the full world (:874)        -> mass/radius all-gathered ONCE
                                               per run (they never change);
                                               positions start sharded.
  per-step MPI_Allgatherv of 10-double      -> per-step all-gather of ONLY x
  body structs (:913-917)                      and y (2 values/body)
  block partitioner recvcounts/displs       -> equal shards via pad_state
  owned-triangle + owned-x-remote forces    -> ops.forces.forces_block_vs_full

Two communication strategies:

  comm="allgather" — every rank holds all positions each step (the
    reference's scheme; memory O(N) per rank, one collective per step).

  comm="ring" — body blocks travel the ring of ranks, one packed
    (x, y, mass, radius) block per hop, while each rank accumulates partial
    forces block by block (memory O(N/P) per rank).  P - 1 hops a step: the
    last visiting block is consumed, not forwarded.

Each rank's force computation (``_local_forces_allgather``,
``_ring_block_forces``, ``_local_forces_ring``) is a plain function of the
tensors it is given and the rank's index; the collectives are only in the
run loop, so the ranks can also be called in one process
(``parallel.emulate``).  With ``kernel="cuda"`` every rank's pass goes
through ``ops.cuda_step.block_forces_auto`` (K1, or K2 above 131072 bodies
in either block; the symmetric pass for a block against itself, as
``takes_symmetric`` says) at the rank's global offsets.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..ops.cuda_step import (any_coincident_tagged, block_forces_auto,
                             forces_coincident_dispatch)
from ..ops.forces import forces_block_vs_full, forces_on_block
from ..ops.integrate import compute_positions, compute_velocities
from ..state import State
from ..utils.debug import check_finite
from .mesh import BODY_AXIS, all_gather, ring_hop, ring_neighbours


def _local_forces_allgather(cfg: SimConfig, x, y, m_blk, r_blk, x_full,
                            y_full, m_full, r_full, rank: int):
    """Forces on rank ``rank``'s block from the gathered full arrays."""
    shard = x.shape[0]
    if cfg.kernel == "cuda":
        # Every rank computes the same coincidence flag from the same
        # gathered data, so no collective is needed for it.
        return forces_coincident_dispatch(
            x_full, y_full, m_full,
            lambda biased: block_forces_auto(
                cfg, x, y, m_blk, r_blk, x_full, y_full, m_full, r_full,
                row_g0=rank * shard, col_g0=0, biased=biased,
                accum=cfg.accum))
    return forces_block_vs_full(cfg, x, y, m_blk, r_blk, x_full, y_full,
                                m_full, r_full, rank * shard)


def _ring_block_forces(cfg: SimConfig, s: int, x, y, m_blk, r_blk, vx, vy,
                       vm, vr, rank: int, p: int):
    """Forces on rank ``rank``'s block from the block it holds at hop ``s``,
    the one first owned by rank (rank + s) mod p: its global offset drives
    self-pair masking and coincident-pair signs."""
    shard = x.shape[0]
    row_g0 = rank * shard
    visit_g0 = ((rank + s) % p) * shard
    if cfg.kernel == "cuda":
        # The kernel handles self-pairs and coincident pairs by global
        # index, so the visiting block needs no own/remote distinction.  The
        # bias is gated per hop by the duplicate test over own + visiting
        # block, tagged by global id so a block visiting itself (s == 0)
        # does not count.
        ids = torch.arange(shard, device=x.device)
        flag = any_coincident_tagged(
            torch.cat([x, vx]), torch.cat([y, vy]), torch.cat([m_blk, vm]),
            torch.cat([row_g0 + ids, visit_g0 + ids]))
        return block_forces_auto(cfg, x, y, m_blk, r_blk, vx, vy, vm, vr,
                                 row_g0=row_g0, col_g0=visit_g0,
                                 biased=flag, accum=cfg.accum)
    if cfg.force_mode == "fast":
        # The fast path masks self-pairs by global index, so s == 0 needs
        # no special case.
        return forces_on_block(cfg, x, y, m_blk, r_blk, vx, vy, vm, vr,
                               same_block=False, gi0=row_g0, gj0=visit_g0)
    if s == 0:
        return forces_on_block(cfg, x, y, m_blk, r_blk, x, y, m_blk, r_blk,
                               same_block=True)
    return forces_on_block(cfg, x, y, m_blk, r_blk, vx, vy, vm, vr,
                           same_block=False, gi0=row_g0, gj0=visit_g0)


def _local_forces_ring(cfg: SimConfig, x, y, m_blk, r_blk, rank: int, p: int,
                       visits):
    """Forces on rank ``rank``'s block, summed over the p packed (4, shard)
    blocks that ``visits`` yields in hop order (its own block first)."""
    xf = torch.zeros_like(x)
    yf = torch.zeros_like(y)
    for s, vb in enumerate(visits):
        dxf, dyf = _ring_block_forces(cfg, s, x, y, m_blk, r_blk, vb[0],
                                      vb[1], vb[2], vb[3], rank, p)
        xf = xf + dxf
        yf = yf + dyf
    return xf, yf


def _ring_visits(vb, p: int, left: int, right: int):
    """The p blocks a rank holds in turn: its own, then each received from
    the right.  The next hop is in flight while the caller computes on the
    current block; the last block is not forwarded (P - 1 hops; none at
    p == 1)."""
    for s in range(p):
        last = s == p - 1
        if not last:
            nxt, reqs = ring_hop(vb, left, right)
        yield vb
        if not last:
            for req in reqs:
                req.wait()
            vb = nxt


def make_sharded_run(cfg: SimConfig, mesh, steps: int,
                     comm: str = "allgather"):
    """The per-rank runner: this rank's shard of a padded ``State`` (see
    ``mesh.shard_state``) -> its shard after ``steps`` steps.  Every rank of
    ``mesh`` calls it.  ``runner(state, nan_check_from=k)`` checks the
    rank's shard after every step, as ``engine.run`` does."""
    if comm not in ("allgather", "ring"):
        raise ValueError("unknown comm %r (expected allgather or ring)"
                         % (comm,))
    if cfg.kernel == "cuda" and cfg.force_mode == "trig":
        raise ValueError("the parity pass runs on one device; ranks take "
                         "the trig path with kernel='dense'")
    group = mesh.get_group(BODY_AXIS)
    rank = mesh.get_local_rank(BODY_AXIS)
    p = mesh.size()
    left, right = ring_neighbours(mesh)

    def run_sharded(state: State, nan_check_from: int | None = None
                    ) -> State:
        x, y, xv, yv, xf, yf, m, r = state
        if comm == "allgather":
            # Masses/radii are constant: gather them once (the Bcast
            # analog).
            m_full = all_gather(m, group)
            r_full = all_gather(r, group)
        for i in range(steps):
            if comm == "allgather":
                xf, yf = _local_forces_allgather(
                    cfg, x, y, m, r, all_gather(x, group),
                    all_gather(y, group), m_full, r_full, rank)
            else:
                visits = _ring_visits(torch.stack([x, y, m, r]), p, left,
                                      right)
                xf, yf = _local_forces_ring(cfg, x, y, m, r, rank, p, visits)
            xv, yv = compute_velocities(cfg, xv, yv, xf, yf, m)
            x, y, xv, yv = compute_positions(cfg, x, y, xv, yv, mass=m)
            if nan_check_from is not None:
                check_finite(State(x, y, xv, yv, xf, yf, m, r),
                             nan_check_from + i + 1)
        return State(x, y, xv, yv, xf, yf, m, r)

    return run_sharded


def make_sharded_step(cfg: SimConfig, mesh, comm: str = "allgather"):
    """A single sharded step (for callers that need per-step control)."""
    return make_sharded_run(cfg, mesh, 1, comm)
