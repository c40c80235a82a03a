"""Rank meshes, the state's shards on them, and their collectives.

The reference's process topology (MPI ranks launched by prun, block body
decomposition via get_recvcounts/get_displacements/get_bounds,
nbody-par.c:225-263) becomes a ``DeviceMesh`` over the ranks of the process
group: one rank is one process with one device, so a P-device mesh is P
ranks.  The remainder handling disappears: the body axis is padded to a
shard multiple (``state.pad_state``) so every rank owns an equal block.

Every rank builds the identical host state (the glibc init is
deterministic: the Bcast analog) and keeps its own slice
``[rank * shard, (rank + 1) * shard)`` on its device; on the 2-D mesh the
rank is ``r * pc + c`` (``init_device_mesh`` lays the ranks out row-major).
A mesh always spans the whole process group.
"""

from __future__ import annotations

import math
import warnings

import torch
import torch.distributed as dist

from ..state import State

BODY_AXIS = "bodies"


def check_mesh_fits(shape: tuple[int, ...], available: int,
                    backend: str) -> None:
    """Raise ValueError, with the JAX package's message, when a mesh of
    ``shape`` needs more devices than ``available``.  A mesh of ranks
    never silently shrinks: the reference's launcher allocates the ranks it
    reports (prun, bin/tests.sh:38)."""
    need = math.prod(shape)
    if need <= available:
        return
    if len(shape) == 1:
        raise ValueError(
            "requested a %d-device mesh but only %d device(s) are available "
            "(backend=%s); on a single-host CPU run set NBODY_PLATFORM=cpu "
            "(each rank is one process)" % (need, available, backend))
    raise ValueError(
        "requested a %s mesh (%d devices) but only %d device(s) are "
        "available" % ("x".join(map(str, shape)), need, available))


def init_mesh(shape: tuple[int, ...], names: tuple[str, ...],
              device_type: str):
    """A ``DeviceMesh`` of ``shape`` over the whole process group."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    check_mesh_fits(shape, world, device_type)
    if math.prod(shape) != world:
        raise ValueError("a mesh of %d ranks in a process group of %d: the "
                         "mesh must span the group" % (math.prod(shape),
                                                       world))
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_mesh(n_devices: int | None = None, device_type: str = "cpu"):
    """1-D mesh of the process group's ranks over the body axis."""
    n = dist.get_world_size() if n_devices is None else n_devices
    return init_mesh((n,), (BODY_AXIS,), device_type)


def body_sharding(mesh, n: int) -> slice:
    """This rank's slice of an ``n``-body axis sharded over every rank of
    ``mesh`` (requires n % mesh.size() == 0: pad_state first)."""
    p = mesh.size()
    if n % p:
        raise ValueError("%d bodies do not shard evenly over %d ranks; pad "
                         "the state first" % (n, p))
    shard = n // p
    rank = mesh.get_rank()
    return slice(rank * shard, (rank + 1) * shard)


def shard_state(state: State, mesh, device) -> State:
    """This rank's shard of the full (padded) ``state``, copied to
    ``device``: the Bcast+scatter analog."""
    sl = body_sharding(mesh, state.n)
    return State(*(a[sl].to(device=device, copy=True) for a in state))


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in group-rank order (the
    tiled ``lax.all_gather``)."""
    out = t.new_empty((t.shape[0] * dist.get_world_size(group),)
                      + tuple(t.shape[1:]))
    with warnings.catch_warnings():
        # Newer torch deprecates the name for all_gather_single, which the
        # older torch on the cards lacks; both have this one.
        warnings.filterwarnings("ignore", category=FutureWarning,
                                message=".*all_gather_into_tensor.*")
        dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def ring_hop(vb: torch.Tensor, left: int, right: int):
    """Start one hop of the ring (``lax.ppermute`` with source i -> i - 1):
    send ``vb`` to the global rank ``left``, receive the same shape from
    ``right``.  Returns (received tensor, requests to wait on)."""
    nxt = torch.empty_like(vb)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, vb, left),
                                   dist.P2POp(dist.irecv, nxt, right)])
    return nxt, reqs


def ring_neighbours(mesh) -> tuple[int, int]:
    """Global ranks (left, right) of this rank on the 1-D body mesh."""
    ranks = mesh.mesh.flatten().tolist()
    me = mesh.get_local_rank(BODY_AXIS)
    p = len(ranks)
    return ranks[(me - 1) % p], ranks[(me + 1) % p]


def gather_state(state: State) -> State:
    """The full state on every rank from each rank's shard, in rank order
    (the ``process_allgather`` analog; the reference's final state is
    likewise complete on rank 0 after the last Allgatherv,
    nbody-par.c:913-944)."""
    return State(*(all_gather(a) for a in state))


def settle(device) -> None:
    """Wait for this rank's queued device work, then for every rank."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dist.barrier()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
