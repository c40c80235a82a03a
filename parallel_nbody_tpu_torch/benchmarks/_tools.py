"""What the speed tools share: the device a run asks for, timing on it, the
record's fingerprint, and where a record goes.

Each tool (``bench``, ``perf_gate``, ``run_benchmarks``,
``ring_bias_probe``, ``bf16_stream_probe``, ``autotune``, ``huge_n``) runs
on the card unless ``--device=cpu`` asks for the CPU
(``utils/device.tool_argv``): without a card it exits 1 and says why, and
prints nothing that looks like a result.  Times on the card come from CUDA
events or a host clock read after ``torch.cuda.synchronize()``, never from
a host readback.  Every record carries ``fingerprint``: the card's name and
power limit as nvidia-smi gives them, the torch, CUDA and driver versions,
and the commit.
"""

from __future__ import annotations

import json
import os
import platform
import subprocess
import time

import torch

from ._probe import device_line

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
# Read when the tree is no git checkout (a copy of one): the commit it
# came from, as the caller knows it.
COMMIT_ENV = "NBODY_GIT_COMMIT"


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall(fn, device):
    """(seconds, result) of ``fn()`` on the host clock, the device
    synchronized before and after."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return time.perf_counter() - t0, out


def best_seconds(fn, device, reps: int) -> float:
    """The best of ``reps`` timed calls of ``fn`` after one warm-up call:
    CUDA events around each call on the card, the host clock on the
    CPU."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            start_ev = torch.cuda.Event(enable_timing=True)
            end_ev = torch.cuda.Event(enable_timing=True)
            start_ev.record()
            fn()
            end_ev.record()
            end_ev.synchronize()
            seconds = start_ev.elapsed_time(end_ev) / 1e3
        else:
            seconds, _ = wall(fn, device)
        best = min(best, seconds)
    return best


def _smi(field: str) -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=%s" % field, "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[torch.cuda.current_device()]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def commit() -> str:
    """The checkout's commit (``git describe --always --dirty``), else
    ``$NBODY_GIT_COMMIT``, else "unknown"."""
    try:
        out = subprocess.run(["git", "describe", "--always", "--dirty"],
                             capture_output=True, text=True, timeout=30,
                             cwd=REPO, check=True)
        if out.stdout.strip():
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return os.environ.get(COMMIT_ENV) or "unknown"


def fingerprint(device) -> dict:
    """What a record was measured on."""
    fp = {"device": device.type, "torch": torch.__version__,
          "commit": commit()}
    if device.type == "cuda":
        fp.update(name=torch.cuda.get_device_name(device),
                  nvidia_smi=device_line(), cuda=torch.version.cuda,
                  driver=_smi("driver_version"))
    else:
        fp.update(name="cpu (%s, %d threads)" % (
            platform.processor() or platform.machine(),
            torch.get_num_threads()))
    return fp


def device_keys(device) -> dict:
    """The device keys of the JAX package's accuracy records (``backend``,
    ``device``), read from the ``fingerprint`` that they carry beside."""
    fp = fingerprint(device)
    return {"backend": device.type,
            "device": fp["name"] if device.type == "cuda" else "cpu",
            "fingerprint": fp}


def record_path(flags: dict, device, name: str):
    """Where a tool writes its record: ``--out=PATH``, else beside the tool
    (``benchmarks/<name>``) for a run on the card; a CPU run writes only
    where ``--out`` says, so it never replaces the card's record."""
    if flags.get("out"):
        return flags["out"]
    return os.path.join(HERE, name) if device.type == "cuda" else None


def write_record(record: dict, path) -> None:
    if path:
        with open(path, "w") as f:
            json.dump(record, f, indent=2)
            f.write("\n")
