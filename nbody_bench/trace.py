"""Reading a ``torch.profiler`` chrome trace of the traced segment.

The harness opens a ``record_function`` range, ``SEGMENT``, around the
profiled part of the window.  Within it:

- every device operation (kernel, copy, set) is tied through its
  correlation id to the host call that launched it, and so to the host
  spans open around that call on its thread: the harness's
  ``record_function`` ranges (``nbench.*``), the operators (``aten::*``)
  and, where the profiler records Python stacks, each Python function of
  the port by its bare name (``any_coincident``, ``cuda_forces``,
  ``compute_velocities``, ...);
- the device is busy where any operation runs, and idle elsewhere; each
  idle gap is labelled by the innermost harness range and the innermost
  operator or Python function open on the harness's thread where it
  starts.
"""

from __future__ import annotations

import dataclasses
import json

SEGMENT = "nbench.segment"
LAYERS = "nbench.layers"
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST = ("python_function", "user_annotation", "cpu_op")
_LAUNCH = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class DeviceOp:
    name: str
    seconds: float
    spans: frozenset  # names of the host spans open around its launch


@dataclasses.dataclass
class TraceView:
    """What the readers of per-layer metrics get from the segment."""

    window_s: float
    busy_s: float
    ops: list
    gaps: list  # (label, seconds), longest first
    host_s: dict  # harness range name -> seconds inside the segment
    steps: int = 0
    frames: int = 0
    enqueue_s: float = 0.0
    enqueue_steps: int = 0
    n: int = 0
    itemsize: int = 4
    layers: "TraceView | None" = None  # the segment traced with stacks

    def device_seconds(self, *names) -> float:
        """Device seconds of the operations launched under any host span
        named in ``names``."""
        want = set(names)
        return sum(op.seconds for op in self.ops if op.spans & want)

    def breakdown(self) -> dict:
        by_name: dict = {}
        for op in self.ops:
            by_name[op.name] = by_name.get(op.name, 0.0) + op.seconds
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in self.gaps[:10]]}


def _short(e) -> str:
    """A host span's name: a Python function's bare name, or the
    range's."""
    name = e.get("name", "")
    if e.get("cat") == "python_function":
        return name.rsplit(": ", 1)[-1]
    return name


def _kernel_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    template and argument lists."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in ("<", "("):
        cut = name.find(stop)
        if cut > 0:
            name = name[:cut]
    return name.strip()[:100]


def _open_spans(spans, times):
    """For each time in ``times``, the spans of one thread open there,
    innermost last.  ``spans``: (start, end, event) of properly nested
    spans."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    order = sorted(range(len(times)), key=lambda i: times[i])
    out = [None] * len(times)
    stack, j = [], 0
    for i in order:
        t = times[i]
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] <= spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out[i] = [s[2] for s in stack if s[0] <= t < s[1]]
    return out


def read(path: str, segment: str = SEGMENT) -> TraceView:
    """The view of the range named ``segment`` of the chrome trace at
    ``path``."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    events = [e for e in events if e.get("ph") == "X" and "dur" in e]
    seg = [e for e in events
           if e.get("cat") == "user_annotation" and e["name"] == segment]
    if not seg:
        return TraceView(0.0, 0.0, [], [], {})
    seg = seg[0]
    t0, t1 = seg["ts"], seg["ts"] + seg["dur"]
    lanes: dict = {}
    for e in events:
        if e.get("cat") in _HOST:
            lanes.setdefault(e["tid"], []).append(
                (e["ts"], e["ts"] + e["dur"], e))
    launches = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in _LAUNCH and corr is not None:
            launches[corr] = e
    device = [e for e in events if e.get("cat") in _DEVICE
              and e["ts"] < t1 and e["ts"] + e["dur"] > t0]
    # The host spans around each operation's launch, thread by thread.
    by_tid: dict = {}
    for i, e in enumerate(device):
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None:
            by_tid.setdefault(launch["tid"], []).append((i, launch["ts"]))
    spans = [frozenset()] * len(device)
    for tid, pairs in by_tid.items():
        opened = _open_spans(lanes.get(tid, []), [ts for _, ts in pairs])
        for (i, _), evs in zip(pairs, opened):
            spans[i] = frozenset(_short(ev) for ev in evs)
    ops, intervals = [], []
    for e, sp in zip(device, spans):
        a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
        ops.append(DeviceOp(_kernel_name(e["name"]), (b - a) * 1e-6, sp))
        intervals.append((a, b))
    busy, gaps, edge = 0.0, [], t0
    for a, b in sorted(intervals):
        if a > edge:
            gaps.append((edge, a))
        if b > edge:
            busy += b - max(a, edge)
            edge = b
    if edge < t1:
        gaps.append((edge, t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    labels = _open_spans(lanes.get(seg["tid"], []), [g[0] for g in gaps[:10]])
    labelled = []
    for (a, b), evs in zip(gaps, labels + [None] * len(gaps)):
        labelled.append((_gap_label(evs), (b - a) * 1e-6))
    host_s: dict = {}
    for e in events:
        if (e.get("cat") == "user_annotation" and e["name"] != segment
                and t0 <= e["ts"] < t1):
            host_s[e["name"]] = host_s.get(e["name"], 0.0) + e["dur"] * 1e-6
    return TraceView((t1 - t0) * 1e-6, busy * 1e-6, ops, labelled, host_s)


def _gap_label(evs) -> str:
    """``<innermost harness range>/<innermost operator or Python
    function>`` of the spans open at a gap's start."""
    if not evs:
        return "none"
    ranges = [_short(e) for e in evs if e.get("cat") == "user_annotation"]
    # Operators, and functions of Python source files (not built-ins).
    funcs = [_short(e) for e in evs if e.get("cat") == "cpu_op"
             or ".py(" in e.get("name", "")]
    return "%s/%s" % (ranges[-1] if ranges else "-",
                      funcs[-1] if funcs else "-")

