"""Launching ranks (the prun/mpirun analog).

The reference launches MPI ranks with DAS-5's ``prun`` (bin/tests.sh:38).
Here one rank is one process with one device, joined into a process group
(gloo on the CPU, NCCL on CUDA cards).  Three ways in:

  - ``torchrun`` (or any launcher that sets ``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK``): every rank runs the CLI, which joins the group
    (``env://``):

        torchrun --nproc-per-node=2 -m parallel_nbody_tpu_torch.cli \\
            97 0 arena.ppm 100 --devices=2

  - the JAX package's manual spelling (bin/multihost-cli.sh):
    ``COORDINATOR_ADDRESS=host:port``, ``NBODY_NUM_PROCESSES`` and
    ``NBODY_PROCESS_ID`` on each process (``tcp://`` rendezvous);

  - neither: ``spawn`` starts the ranks itself (``torch.multiprocessing``,
    start method spawn), joined through a ``FileStore`` in a temporary
    directory, so no port is needed and one command prints one result.
"""

from __future__ import annotations

import contextlib
import os
import socket
import sys
import tempfile


def running_under_pod_launcher() -> bool:
    """True when a launcher has configured this process as one rank of a
    group: torchrun's ``RANK`` and ``WORLD_SIZE``, or an explicit
    coordinator address."""
    return (("RANK" in os.environ and "WORLD_SIZE" in os.environ)
            or "COORDINATOR_ADDRESS" in os.environ)


def launcher_ranks() -> tuple[int, int]:
    """(rank, world size) that the launcher configured, from the
    environment."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return (int(os.environ.get("NBODY_PROCESS_ID", "0")),
            int(os.environ.get("NBODY_NUM_PROCESSES", "1")))


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _rank_device(device_type: str, local_rank: int):
    """This rank's device; on CUDA it becomes the current device before the
    group is made, so NCCL binds the right card."""
    import torch
    if device_type != "cuda":
        return torch.device("cpu")
    torch.cuda.set_device(local_rank)
    return torch.device("cuda", local_rank)


def initialize(device_type: str, coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None):
    """Join the launcher's process group; returns this rank's device.

    Under torchrun the group comes from the environment (``env://``).
    Otherwise the coordinator address (``host:port``) and the process count
    and index, as arguments or as ``COORDINATOR_ADDRESS``,
    ``NBODY_NUM_PROCESSES`` and ``NBODY_PROCESS_ID``, give a ``tcp://``
    rendezvous.  ``LOCAL_RANK`` (else the rank) picks the card."""
    import torch.distributed as dist

    rank, world = launcher_ranks()
    rank = rank if process_id is None else process_id
    world = world if num_processes is None else num_processes
    device = _rank_device(device_type,
                          int(os.environ.get("LOCAL_RANK", rank)))
    address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    init = ("tcp://" + address if address and "RANK" not in os.environ
            else "env://")
    dist.init_process_group(_backend(device_type), init_method=init,
                            rank=rank, world_size=world)
    return device


def topology() -> dict:
    """The group's topology for the experiment CSV (the PRUN env-scrape
    analog, nbody-par.c:441-517).  A collective: every rank calls it.
    ``hosts`` counts distinct host names, so ranks spawned by one command
    are one node."""
    import torch.distributed as dist

    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    me = socket.gethostname()
    return {
        "processes": dist.get_world_size(),
        "process_id": dist.get_rank(),
        "global_devices": dist.get_world_size(),
        "local_devices": names.count(me),
        "hosts": len(set(names)),
    }


def _spawned_rank(rank, fn, args, world, tmp, device_type, threads):
    """Body of one spawned rank: join the group through the FileStore, run
    ``fn(device, *args)``; rank 0's stdout and stderr go to files the parent
    relays, the other ranks' stdout to nowhere."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(threads)
    device = _rank_device(device_type, rank)
    out_path = os.path.join(tmp, "rank0.out")
    err_path = os.path.join(tmp, "rank0.err")
    with contextlib.ExitStack() as stack:
        if rank == 0:
            out = stack.enter_context(open(out_path, "w", buffering=1))
            err = stack.enter_context(open(err_path, "w", buffering=1))
            stack.enter_context(contextlib.redirect_stderr(err))
        else:
            out = stack.enter_context(open(os.devnull, "w"))
        stack.enter_context(contextlib.redirect_stdout(out))
        store = dist.FileStore(os.path.join(tmp, "store"), world)
        dist.init_process_group(_backend(device_type), store=store,
                                rank=rank, world_size=world)
        try:
            rc = fn(device, *args)
        finally:
            dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(tmp, "rank0.rc"), "w") as f:
            f.write("%d" % rc)


def spawn(fn, nprocs: int, device_type: str, args=(), threads: int = 1
          ) -> int:
    """Run ``fn(device, *args)`` on ``nprocs`` new ranks of one process
    group and wait for them; rank ``k`` gets card ``k`` on CUDA.  Rank 0's
    output is written to this process's stdout and stderr when the ranks
    are done; its return value is returned.  If a rank raises, the others
    are stopped, its traceback goes to stderr and 1 is returned.  ``fn``
    must be importable by name (the children start from a fresh import)."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    with tempfile.TemporaryDirectory(prefix="nbody_ranks_") as tmp:
        failure = None
        try:
            mp.start_processes(_spawned_rank,
                               args=(fn, args, nprocs, tmp, device_type,
                                     threads),
                               nprocs=nprocs, start_method="spawn")
        except ProcessException as e:
            failure = e
        for name, stream in (("rank0.out", sys.stdout),
                             ("rank0.err", sys.stderr)):
            path = os.path.join(tmp, name)
            if os.path.exists(path):
                with open(path) as f:
                    stream.write(f.read())
        if failure is not None:
            sys.stderr.write("rank %d failed: %s\n"
                             % (failure.error_index, failure))
            return 1
        with open(os.path.join(tmp, "rank0.rc")) as f:
            return int(f.read())
