"""Every rank's force computation called in one process.

Each rank's inputs are cut from the full padded state as the run loops'
collectives would deliver them (gathered arrays, visiting blocks, row and
col groups), and the rank's collective-free force function is called on
them.  The run loops (``sharded_step``, ``grid2d``) call the same functions,
so this holds the decomposition — offsets, shapes, chunking, the tagged
coincidence flags — to the single-device pass without a process group: the
CPU tests against the JAX package's sharded runs, and on one card every
rank's pass through the CUDA kernels.

A layout is ``("allgather", p)``, ``("ring", p)`` or ``("grid2d", pr,
pc)``.
"""

from __future__ import annotations

import functools

import torch

from ..config import SimConfig
from ..state import State
from .grid2d import cell_forces
from .sharded_step import _local_forces_allgather, _local_forces_ring


def ranks(layout) -> int:
    return layout[1] * (layout[2] if layout[0] == "grid2d" else 1)


def _blocks(state: State, p: int):
    """The (x, y, mass, radius) block of each of p ranks."""
    if state.n % p:
        raise ValueError("%d bodies do not shard evenly over %d ranks; pad "
                         "the state first" % (state.n, p))
    shard = state.n // p
    full = (state.x, state.y, state.mass, state.radius)
    return [tuple(a[k * shard:(k + 1) * shard] for a in full)
            for k in range(p)]


def rank_programs(cfg: SimConfig, state: State, layout):
    """One zero-argument callable per rank (in rank order), each running
    that rank's force computation on the full padded ``state``: it returns
    the rank's (xf, yf) for allgather and ring, and its row group's partial
    forces for grid2d."""
    kind = layout[0]
    if kind == "grid2d":
        _, pr, pc = layout
        blocks = _blocks(state, pr * pc)
        progs = []
        for r in range(pr):
            row = [torch.cat(parts) for parts in
                   zip(*blocks[r * pc:(r + 1) * pc])]
            for c in range(pc):
                col = [torch.cat(parts) for parts in
                       zip(*blocks[c::pc])]
                progs.append(functools.partial(cell_forces, cfg, *row, *col,
                                               r, c, pr, pc))
        return progs
    p = layout[1]
    blocks = _blocks(state, p)
    if kind == "allgather":
        full = (state.x, state.y, state.mass, state.radius)
        return [functools.partial(_local_forces_allgather, cfg, *blocks[k],
                                  *full, k) for k in range(p)]
    if kind == "ring":
        packed = [torch.stack(b) for b in blocks]
        return [functools.partial(_local_forces_ring, cfg, *blocks[k], k, p,
                                  [packed[(k + s) % p] for s in range(p)])
                for k in range(p)]
    raise ValueError("unknown layout %r" % (layout,))


def combine(outputs, layout):
    """The full (xf, yf) from ``rank_programs``' outputs, in rank order.
    For grid2d each row group's partials are summed over its ranks in
    column order (the all-reduce over "cols") and every rank keeps its own
    slice."""
    if layout[0] != "grid2d":
        return (torch.cat([o[0] for o in outputs]),
                torch.cat([o[1] for o in outputs]))
    _, pr, pc = layout
    xf, yf = [], []
    for r in range(pr):
        row = outputs[r * pc:(r + 1) * pc]
        fx, fy = row[0]
        for dfx, dfy in row[1:]:
            fx, fy = fx + dfx, fy + dfy
        xf.append(fx)
        yf.append(fy)
    return torch.cat(xf), torch.cat(yf)


def forces(cfg: SimConfig, state: State, layout):
    """Full (xf, yf) of one step's force pass under ``layout``, every rank
    computed in this process."""
    return combine([prog() for prog in rank_programs(cfg, state, layout)],
                   layout)
