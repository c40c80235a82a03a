"""Instrumentation: wall-clock timing and profiler traces.

``trace`` wraps a region in a ``torch.profiler`` trace (CPU activity, and
CUDA activity when a card is present) and writes it as a gzipped Chrome
trace under the given directory; ``trace_comm_share`` reads the newest trace
there and reports how much of the leaf op time went to collectives.  On one
device that share is zero; the sharded programs use it to measure their
communication inside the real program instead of timing it in isolation
(reference bracket: nbody-par.c:912-918).
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import shutil
import time

from .output import nr_flops, pair_interactions


class StepTimer:
    """Wall-clock timing + the reference's throughput accounting."""

    def __init__(self, n: int, steps: int):
        self.n = n
        self.steps = steps
        self.rtime = 0.0

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.rtime = time.time() - self._t0
        return False

    @property
    def gflops(self) -> float:
        return nr_flops(self.n, self.steps) / 1e9 / self.rtime

    @property
    def interactions_per_sec(self) -> float:
        return pair_interactions(self.n, self.steps) / self.rtime


_TRACE_SUFFIX = ".trace.json.gz"


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace context (the deep-profiling path the reference
    lacks).  On exit the trace is written to
    ``log_dir/<time in ns>_<pid>.trace.json.gz``; open it in chrome://tracing or
    Perfetto.  The caller synchronizes the device before leaving the
    context, or kernels still in flight are missing from the trace."""
    import torch
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


def _leaf_events(events):
    """The events that contain no other event of their thread: operators
    nest (``aten::add`` calls ``aten::to``), and summing a parent with its
    children would count the children's time twice."""
    lanes: dict = {}
    for e in events:
        lanes.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for lane in lanes.values():
        # A parent sorts just before its first child: same or earlier start,
        # longer duration.
        lane.sort(key=lambda e: (e["ts"], -e["dur"]))
        for e, nxt in zip(lane, lane[1:] + [None]):
            if nxt is None or nxt["ts"] >= e["ts"] + e["dur"]:
                yield e


def trace_comm_share(log_dir: str) -> dict:
    """Collective share read from the newest trace under ``log_dir``.

    Sums complete-event durations of the device's kernels and copies; a
    trace without any (a run on the CPU) sums the leaf operators instead.
    Collectives are classified by name.  Durations aggregate over every
    stream and thread, so the SHARE is meaningful even where the absolute
    sums exceed wall time.  Returns {"collective_us", "op_us", "share",
    "by_op": {name: us}}.
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
    ops = [e for e in complete if e.get("cat") in _DEVICE_CATEGORIES]
    if not ops:
        ops = list(_leaf_events(
            [e for e in complete if e.get("cat") == _HOST_OP_CATEGORY]))
    coll_us = 0.0
    op_us = 0.0
    by_op: dict = {}
    for e in ops:
        name = e.get("name", "")
        op_us += e["dur"]
        if any(c in name.lower() for c in _TRACE_COLLECTIVE):
            coll_us += e["dur"]
            by_op[name] = by_op.get(name, 0.0) + e["dur"]
    return {"collective_us": coll_us, "op_us": op_us,
            "share": coll_us / op_us if op_us else 0.0, "by_op": by_op}
