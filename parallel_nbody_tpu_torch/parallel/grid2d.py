"""2-D interaction-matrix decomposition over a (rows, cols) mesh of ranks.

The 1-D programs decompose the BODY axis: every rank owns N/P bodies and
per-step communication moves O(N) positions.  The classic force-matrix
decomposition (Plimpton 1995) shards the N x N interaction matrix over a
2-D grid of ranks instead, ``init_device_mesh(..., (pr, pc),
mesh_dim_names=("rows", "cols"))``:

  - bodies are block-sharded over all P = pr * pc ranks: rank (r, c) (global
    rank r * pc + c) owns block r * pc + c;
  - per step, rank (r, c) all-gathers its ROW GROUP over the "cols" axis
    (the contiguous N/pr bodies of row-block r) and its COL GROUP over the
    "rows" axis (the strided N/pc bodies whose block index is c mod pc);
  - it computes the (N/pr x N/pc) partial force block one-sidedly, masking
    true self-pairs by global body index (``cell_forces``);
  - an all-reduce over "cols" sums the partials into the total force on the
    row group, from which the rank takes its own N/P bodies.

Per-step comm per rank: O(N/pr) + O(N/pc) gathered positions + an O(N/pr)
all-reduce; compute per rank is N^2/P pairs, as in the 1-D programs.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import SimConfig
from ..ops.cuda_step import any_coincident_tagged, block_forces_auto
from ..ops.forces import _forces_fast_block, _trig_cross_block
from ..ops.integrate import compute_positions, compute_velocities
from ..state import State
from ..utils.debug import check_finite
from .mesh import all_gather, init_mesh, shard_state

ROW_AXIS = "rows"
COL_AXIS = "cols"


def make_mesh2d(pr: int, pc: int, device_type: str = "cpu"):
    """(pr, pc) mesh of the process group's ranks over ("rows", "cols")."""
    return init_mesh((pr, pc), (ROW_AXIS, COL_AXIS), device_type)


def shard_state_2d(state: State, mesh, device) -> State:
    """This rank's shard of the state, body-sharded over the flattened
    mesh (block r * pc + c on rank (r, c))."""
    return shard_state(state, mesh, device)


def group_ids(blk: int, my_r: int, my_c: int, pr: int, pc: int, device):
    """Global ids of rank (my_r, my_c)'s row group (contiguous) and col
    group (strided: one ``blk`` chunk per mesh row)."""
    row_n = blk * pc
    gid_row = my_r * row_n + torch.arange(row_n, device=device)
    rr = torch.arange(pr, device=device)
    gid_col = ((rr[:, None] * pc + my_c) * blk
               + torch.arange(blk, device=device)[None, :]).reshape(-1)
    return gid_row, gid_col


def cell_forces(cfg: SimConfig, x_row, y_row, m_row, r_row, x_col, y_col,
                m_col, r_col, my_r: int, my_c: int, pr: int, pc: int):
    """Rank (my_r, my_c)'s partial forces: the one-sided force of its col
    group on its row group, self-pairs masked by global id.  Returns two
    (N/pr,) tensors, to be summed over the "cols" axis."""
    blk = x_col.shape[0] // pr
    gid_row, gid_col = group_ids(blk, my_r, my_c, pr, pc, x_row.device)
    if cfg.kernel == "cuda":
        # The kernels' offsets describe contiguous blocks, and the col group
        # is strided: one call per contiguous chunk, added in chunk order.
        # The coincident bias is gated per step by the duplicate test over
        # the row and col groups, tagged by global id (a body in both
        # groups does not count).
        flag = any_coincident_tagged(
            torch.cat([x_row, x_col]), torch.cat([y_row, y_col]),
            torch.cat([m_row, m_col]), torch.cat([gid_row, gid_col]))
        fx = torch.zeros_like(x_row)
        fy = torch.zeros_like(y_row)
        for rr in range(pr):
            sl = slice(rr * blk, (rr + 1) * blk)
            dfx, dfy = block_forces_auto(
                cfg, x_row, y_row, m_row, r_row, x_col[sl], y_col[sl],
                m_col[sl], r_col[sl], row_g0=my_r * blk * pc,
                col_g0=(rr * pc + my_c) * blk, biased=flag, accum=cfg.accum)
            fx = fx + dfx
            fy = fy + dfy
        return fx, fy
    if cfg.force_mode == "trig":
        return _trig_cross_block(cfg, x_row, y_row, m_row, r_row, x_col,
                                 y_col, m_col, r_col, 0, 0,
                                 gids=(gid_row, gid_col))
    return _forces_fast_block(cfg, x_row, y_row, m_row, x_col, y_col, m_col,
                              r_row, r_col, 0, 0, gids=(gid_row, gid_col))


def make_grid2d_run(cfg: SimConfig, mesh, steps: int):
    """The per-rank runner of the 2-D decomposition: this rank's shard of a
    padded ``State`` (padded to pr * pc) -> its shard after ``steps``
    steps.  Every rank of ``mesh`` calls it; ``nan_check_from`` as in
    ``sharded_step.make_sharded_run``."""
    rows = mesh.get_group(ROW_AXIS)  # same column: gathers the col group
    cols = mesh.get_group(COL_AXIS)  # same row: gathers the row group
    my_r = mesh.get_local_rank(ROW_AXIS)
    my_c = mesh.get_local_rank(COL_AXIS)
    pr, pc = mesh.shape

    def run_grid2d(state: State, nan_check_from: int | None = None
                   ) -> State:
        x, y, xv, yv, xf, yf, m, r = state
        blk = x.shape[0]
        # Masses/radii never change: gather the groups once (the Bcast
        # analog).
        m_row, r_row = all_gather(m, cols), all_gather(r, cols)
        m_col, r_col = all_gather(m, rows), all_gather(r, rows)
        for i in range(steps):
            fx, fy = cell_forces(cfg, all_gather(x, cols),
                                 all_gather(y, cols), m_row, r_row,
                                 all_gather(x, rows), all_gather(y, rows),
                                 m_col, r_col, my_r, my_c, pr, pc)
            # Total force on the row group, the same on every rank of it.
            dist.all_reduce(fx, group=cols)
            dist.all_reduce(fy, group=cols)
            # This rank's bodies are the my_c-th block of its row group.
            xf = fx[my_c * blk:(my_c + 1) * blk].clone()
            yf = fy[my_c * blk:(my_c + 1) * blk].clone()
            xv, yv = compute_velocities(cfg, xv, yv, xf, yf, m)
            x, y, xv, yv = compute_positions(cfg, x, y, xv, yv, mass=m)
            if nan_check_from is not None:
                check_finite(State(x, y, xv, yv, xf, yf, m, r),
                             nan_check_from + i + 1)
        return State(x, y, xv, yv, xf, yf, m, r)

    return run_grid2d
