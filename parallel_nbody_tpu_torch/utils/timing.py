"""Instrumentation: program spans, communication time and profiler traces.

``span(name)`` marks a layer of the program (``nbody.step`` and its three
children ``nbody.coincident``, ``nbody.forces``, ``nbody.integrate``;
``nbody.render``; the CLI's ``nbody.frame.copy`` and ``nbody.frame.write``)
as a ``torch.profiler`` range while a profiler records, and costs one flag
check otherwise; the profiler that records keeps the spans and writes them
into its trace, beside the kernels they launched.  The reference brackets
its per-step MPI_Allgatherv with MPI_Wtime under ``--measure-comm``
(nbody-par.c:912-918).  ``measure_comm_fraction`` times the sharded step's
collectives alone, on the same shards, as the JAX package times a comm-only
program.  ``trace`` wraps a region in a ``torch.profiler`` trace (CPU
activity, and CUDA activity when a card is present) and writes it as a
gzipped Chrome trace under the given directory; ``trace_comm_share`` reads
the newest trace there and reports how much of the leaf op time went to
collectives (gloo and NCCL operations), measured inside the real program.
On one device that share is zero.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import shutil
import time

import torch

# Returned by ``span`` while no profiler records: one shared instance, so
# an unrecorded span builds nothing.
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that marks ``name`` as a range of the program: a
    ``torch.profiler.record_function`` while a ``torch.profiler`` records
    (``trace``, the CLI's ``--trace=DIR``, a ``profile(...).start()`` of the
    caller), else a shared no-op context.  The check reads the profiler's
    own process-wide flag, so spans cost one attribute read when off."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def measure_comm_fraction(cfg, mesh, state, comm: str,
                          iters: int = 30) -> float:
    """Per-step communication time (seconds) of the sharded step's
    collectives, timed alone on this rank's shard ``state``: the positional
    all-gather, the ring's p - 1 hops of one packed (4, shard) block, or the
    grid's row and col gathers and its all-reduce (``comm="grid2d"``).  A
    collective: every rank calls it.  One untimed round first; the timed
    rounds end with a synchronize and a barrier, so the figure covers the
    slowest rank.  ``cfg`` is unused (kept for the JAX signature)."""
    import torch.distributed as dist

    from ..parallel.mesh import (BODY_AXIS, all_gather, ring_hop,
                                 ring_neighbours, settle)

    x, y = state.x, state.y
    if comm == "grid2d":
        from ..parallel.grid2d import COL_AXIS, ROW_AXIS
        rows, cols = mesh.get_group(ROW_AXIS), mesh.get_group(COL_AXIS)

        def exchange():
            fx, fy = all_gather(x, cols), all_gather(y, cols)
            all_gather(x, rows)
            all_gather(y, rows)
            dist.all_reduce(fx, group=cols)
            dist.all_reduce(fy, group=cols)
    elif comm == "allgather":
        group = mesh.get_group(BODY_AXIS)

        def exchange():
            all_gather(x, group)
            all_gather(y, group)
    else:
        left, right = ring_neighbours(mesh)
        hops = mesh.size() - 1

        def exchange():
            vb = torch.stack([x, y, x, y])
            for _ in range(hops):
                vb, reqs = ring_hop(vb, left, right)
                for req in reqs:
                    req.wait()

    exchange()
    settle(x.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        exchange()
    settle(x.device)
    return (time.perf_counter() - t0) / iters


_TRACE_SUFFIX = ".trace.json.gz"


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace context (the deep-profiling path the reference
    lacks).  On exit the trace is written to
    ``log_dir/<time in ns>_<pid>.trace.json.gz``; open it in chrome://tracing or
    Perfetto.  The caller synchronizes the device before leaving the
    context, or kernels still in flight are missing from the trace."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        stem = os.path.join(log_dir, "%d_%d" % (time.time_ns(), os.getpid()))
        raw = stem + ".json"
        prof.export_chrome_trace(raw)
        try:
            with open(raw, "rb") as src, \
                    gzip.open(stem + _TRACE_SUFFIX, "wb") as dst:
                shutil.copyfileobj(src, dst)
        finally:
            os.remove(raw)


# Chrome-trace categories of work on the device, and of operators on the
# host (what a run on the CPU consists of).
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_OP_CATEGORY = "cpu_op"
# Names marking collective communication: the backends' kernels and the
# c10d operators.
_TRACE_COLLECTIVE = ("nccl", "gloo", "c10d", "all_gather", "allgather",
                     "all_reduce", "allreduce", "reduce_scatter",
                     "all_to_all", "alltoall")


def _is_collective(name: str) -> bool:
    return any(c in name.lower() for c in _TRACE_COLLECTIVE)


def _host_leaves(events):
    """(event, collective) for the operators that contain no other operator
    of their thread: operators nest (``aten::add`` calls ``aten::to``), and
    summing a parent with its children would count the children's time
    twice.  ``collective`` is the name of the outermost collective operator
    that contains the leaf, or is the leaf (``c10d::allgather_`` runs
    copies), else None."""
    lanes: dict = {}
    for e in events:
        lanes.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for lane in lanes.values():
        # A parent sorts just before its first child: same or earlier start,
        # longer duration.
        lane.sort(key=lambda e: (e["ts"], -e["dur"]))
        ancestors = []  # (end, collective) of the open operators
        for e, nxt in zip(lane, lane[1:] + [None]):
            while ancestors and ancestors[-1][0] <= e["ts"]:
                ancestors.pop()
            outer = ancestors[-1][1] if ancestors else None
            coll = outer or (e["name"] if _is_collective(e["name"]) else None)
            if nxt is None or nxt["ts"] >= e["ts"] + e["dur"]:
                yield e, coll
            else:
                ancestors.append((e["ts"] + e["dur"], coll))


def trace_comm_share(log_dir: str) -> dict:
    """Collective share read from the newest trace under ``log_dir``.

    Sums complete-event durations of the device's kernels and copies,
    collectives (NCCL's kernels) classified by name; a trace without any (a
    run on the CPU) sums the leaf operators instead, and counts as
    collective time those inside a collective operator (gloo's).  Durations
    aggregate over every stream and thread, so the SHARE is meaningful even
    where the absolute sums exceed wall time.  Returns {"collective_us",
    "op_us", "share", "by_op": {name: us}}.
    """
    # A reused log_dir accumulates runs, and summing them all would blend
    # different programs into one bogus share: read only the newest.
    files = glob.glob(os.path.join(log_dir, "**", "*" + _TRACE_SUFFIX),
                      recursive=True)
    if not files:
        raise FileNotFoundError("no *%s under %s" % (_TRACE_SUFFIX, log_dir))
    with gzip.open(max(files, key=os.path.getmtime), "rt") as fh:
        events = json.load(fh).get("traceEvents", [])
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    ops = [(e, e["name"] if _is_collective(e.get("name", "")) else None)
           for e in complete if e.get("cat") in _DEVICE_CATEGORIES]
    if not ops:
        ops = list(_host_leaves(
            [e for e in complete if e.get("cat") == _HOST_OP_CATEGORY]))
    coll_us = 0.0
    op_us = 0.0
    by_op: dict = {}
    for e, coll in ops:
        op_us += e["dur"]
        if coll is not None:
            coll_us += e["dur"]
            by_op[coll] = by_op.get(coll, 0.0) + e["dur"]
    return {"collective_us": coll_us, "op_us": op_us,
            "share": coll_us / op_us if op_us else 0.0, "by_op": by_op}
