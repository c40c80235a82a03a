"""Long-run energy drift of the speed configuration against float64.

The counterpart of the JAX package's ``benchmarks/drift_study.py``
(BASELINE config 3).  At N=65536 from the glibc init, for three modes —
fp32 ``plain``, fp32 ``compensated`` (Kahan) and ``bfloat16`` storage — on
K1 (``kernel="cuda"``):

  1. the force operator (``cuda_forces``, biased) on the initial state
     against float64 rows (``ops.forces.forces_on_block``, 512 rows at a
     time) over the first ``ORACLE_ROWS`` rows: the maximum and mean of
     ``|d| / (|F| + 1)``;
  2. ``STEPS`` steps in chunks of ``CHUNK``, the total energy in float64 at
     ``(0, STEPS / 2, STEPS)`` (``total_energy_chunked``: 512 rows at a
     time, since ``engine.total_energy`` builds the whole (N, N) matrix),
     and the drift ``|E_t - E_0| / |E_0|``;
  3. the cost per step: the best of 3 runs of ``CHUNK`` steps, by CUDA
     events on the card.

bfloat16 cannot hold the glibc init exactly (integers above 256 round
under an 8-bit mantissa), so the bf16 mode runs from its own quantized
init, and its force oracle and E0 are evaluated on those quantized values
cast up; ``init_quantization`` reports how far they are from the fp32 init.

    python -m parallel_nbody_tpu_torch.benchmarks.drift_study \\
        [--device=cpu|cuda] [--out=PATH]

prints the record as JSON (the keys of the JAX package's
``benchmarks/drift_study.json``, with the card's name and power limit) and
writes it to PATH when given.  It exits 1 without a CUDA device unless
``--device=cpu``; on the CPU the kernels' plain versions run at the reduced
sizes ``CPU_SIZES``.  The float64 oracle runs in the same process on the
same device; it is plain tensor code that shares nothing with K1.
"""

from __future__ import annotations

import json
import sys
import time
from typing import NamedTuple

import torch

from ..config import SimConfig
from ..models.engine import run
from ..ops.cuda_step import cuda_forces
from ..state import init_state
from ..utils.device import resolve, tool_argv
from ._tools import device_keys
from .hw_validate import oracle_forces

N = 65536
STEPS = 5000
CHUNK = 500
ORACLE_ROWS = 8192
ROW_CHUNK = 512

MODES = ("plain", "compensated", "bfloat16")
TIMING_REPS = 3


class Sizes(NamedTuple):
    """The study's N, steps (the energy is taken at 0, steps / 2 and
    steps), chunk and oracle rows."""

    n: int
    steps: int
    chunk: int
    oracle_rows: int


FULL_SIZES = Sizes(N, STEPS, CHUNK, ORACLE_ROWS)
CPU_SIZES = Sizes(512, 100, 50, 256)


def mode_cfg(mode: str) -> SimConfig:
    if mode == "bfloat16":
        return SimConfig(force_mode="fast", dtype="bfloat16", kernel="cuda")
    return SimConfig(force_mode="fast", dtype="float32", kernel="cuda",
                     accum=mode)


def energy_at(steps: int):
    return (0, steps // 2, steps)


def total_energy_chunked(gravity: float, x, y, xv, yv, mass, radius,
                         row_chunk: int = ROW_CHUNK) -> float:
    """Kinetic plus softened potential energy in float64, ``row_chunk``
    rows of the pair matrix at a time (each unordered pair is met twice and
    halved).  The same law as ``engine.total_energy``, which builds the
    whole (N, N) matrix."""
    x, y, xv, yv, mass, radius = (t.to(torch.float64)
                                  for t in (x, y, xv, yv, mass, radius))
    n = x.shape[0]
    cols = torch.arange(n, device=x.device)[None, :]
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for r0 in range(0, n, row_chunk):
        sl = slice(r0, min(n, r0 + row_chunk))
        dx = x[None, :] - x[sl, None]
        dy = y[None, :] - y[sl, None]
        dsqr = dx * dx + dy * dy
        mind = radius[sl, None] + radius[None, :]
        d = torch.sqrt(torch.maximum(dsqr, mind * mind).clamp(min=1e-30))
        rows = torch.arange(sl.start, sl.stop, device=x.device)[:, None]
        pe = torch.where(rows != cols,
                         -gravity * mass[sl, None] * mass[None, :] / d, 0.0)
        ke = 0.5 * torch.sum(mass[sl] * (xv[sl] ** 2 + yv[sl] ** 2))
        total += ke + 0.5 * torch.sum(pe)
    return float(total)


def _time_per_step(cfg, st, steps, device) -> float:
    """Seconds per step: the best of ``TIMING_REPS`` runs of ``steps``
    steps from ``st`` (CUDA events on the card, the host clock on the
    CPU), after one warm-up step."""
    run(cfg, st, 1)
    best = float("inf")
    for _ in range(TIMING_REPS):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(cfg, st, steps)
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            run(cfg, st, steps)
            seconds = time.perf_counter() - t0
        best = min(best, seconds / steps)
    return best


def run_study(device=None, sizes: Sizes | None = None, log=print) -> dict:
    """The three measurements for every mode on ``device`` (the card unless
    "cpu" is asked for); returns the record.  ``sizes`` defaults to
    ``FULL_SIZES`` on the card and ``CPU_SIZES`` on the CPU."""
    device = resolve(device)
    if sizes is None:
        sizes = FULL_SIZES if device.type == "cuda" else CPU_SIZES
    n, steps, chunk, rows = sizes
    targets = energy_at(steps)
    st0 = init_state(n, mode_cfg("plain"), device=device)
    st0b = init_state(n, mode_cfg("bfloat16"), device=device)
    inputs = {"fp32": st0, "bf16": st0b}
    gravity = mode_cfg("plain").gravity
    init_quant = {
        k + "_max_abs": float((getattr(st0b, k).double()
                               - getattr(st0, k).double()).abs().max())
        for k in ("x", "y", "mass")}
    oracle_f = {}
    for key, s in inputs.items():
        t0 = time.perf_counter()
        oracle_f[key] = oracle_forces(s.x, s.y, s.mass, s.radius, rows)
        log("float64 force oracle[%s] (%d x %d) in %.3f s"
            % (key, rows, n, time.perf_counter() - t0))
    e0 = {key: total_energy_chunked(gravity, s.x, s.y, s.xv, s.yv, s.mass,
                                    s.radius) for key, s in inputs.items()}

    force_err, drift, timings = {}, {}, {}
    for mode in MODES:
        cfg = mode_cfg(mode)
        key = "bf16" if mode == "bfloat16" else "fp32"
        st = inputs[key]
        fx, fy = cuda_forces(cfg, st.x, st.y, st.mass, st.radius,
                             biased=True, accum=cfg.accum)
        wx, wy = oracle_f[key]
        rel = torch.maximum(
            (fx[:rows].double() - wx).abs() / (wx.abs() + 1.0),
            (fy[:rows].double() - wy).abs() / (wy.abs() + 1.0))
        force_err[mode] = {"max_rel": float(rel.max()),
                           "mean_rel": float(rel.mean())}
        timings[mode] = _time_per_step(cfg, st, chunk, device)

        drift[mode] = {"E0": e0[key]}
        done = 0
        t0 = time.perf_counter()
        for target in targets[1:]:
            while done < target:
                k = min(chunk, target - done)
                st = run(cfg, st, k)
                done += k
            et = total_energy_chunked(gravity, st.x, st.y, st.xv, st.yv,
                                      st.mass, st.radius)
            drift[mode]["E%d" % target] = et
            drift[mode]["drift_%d" % target] = abs(et - e0[key]) / abs(
                e0[key])
        log("%s: %d steps in %.3f s (%.6f ms/step best), force max_rel "
            "%.6e, drift %s" % (mode, steps, time.perf_counter() - t0,
                                timings[mode] * 1e3,
                                force_err[mode]["max_rel"],
                                {k: v for k, v in drift[mode].items()
                                 if k.startswith("drift")}))

    return {"force_operator_vs_fp64": force_err, "energy": drift,
            "init_quantization": init_quant,
            "n": n, "steps": steps, "chunk": chunk, "oracle_rows": rows,
            "timings": timings, "skipped": False, **device_keys(device)}


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    got = tool_argv("drift_study", argv)
    if got is None:
        return 1
    _, flags, device = got
    record = run_study(device, log=lambda s: print(s, flush=True))
    record["when"] = time.strftime("%Y-%m-%d %H:%M:%S")
    if flags.get("out"):
        with open(flags["out"], "w") as f:
            json.dump(record, f, indent=2)
            f.write("\n")
    print(json.dumps(record, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
