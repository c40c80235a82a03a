#!/usr/bin/env python3
"""Smoke run of parallel_nbody_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the CUDA force kernel from csrc/ (nvcc), holds it against its plain
PyTorch version on the card, drives the CLI's main path at N=65536 for 100
steps through the kernel, checks the printed state of a small run against
the CPU, and times the kernel against its plain version.  Every phase
passes or raises: any failure exits non-zero before the result lines.  The
last two lines of stdout are the kernel table and the result, as JSON.

Tolerances (each comparison uses the reference's max |F| as the scale):
  - kernel vs plain version, fp32: 2e-5 * max|F|.  The kernel sums each
    row sequentially in fp32 (error grows like sqrt(N): an emulation on the
    CPU gave 8e-7 of max|F| at N=4097 and 1.8e-6 at N=16384); rsqrtf adds
    2 ulp per term.
  - kernel vs plain version, fp64: 1e-12 * max|F| (the same sums in fp64).
  - the N=1024, 10-step CLI run on the card (fp32) against the same run on
    the CPU in fp32: positions and velocities within 2e-3 (two units of the
    printed %.3f), forces within 1e-4 * max|F|; against the CPU in fp64:
    positions and velocities within 5e-3, forces within 1e-2 * max|F|.
    fp32 positions quantize at ~6e-5 near x=1000 while a body moves ~2.5e-5
    per step, so close pairs' forces drift from the fp64 run by up to 0.4%
    of max|F| in 10 steps (measured on the CPU).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

KICK = 38.5 / 9.0  # G * 5 * 7 / (1.5 + 1.5)^2
TOL = {torch.float32: 2e-5, torch.float64: 1e-12}
MAIN_N, MAIN_STEPS = 65536, 100


def _cfg(dtype):
    from parallel_nbody_tpu_torch.config import SimConfig
    return SimConfig(force_mode="fast", dtype=dtype, kernel="cuda")


def phase_device():
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print("device: %s, capability %s, count %d, torch %s, cuda %s"
          % (name, cap, torch.cuda.device_count(), torch.__version__,
             torch.version.cuda))
    if cap != (9, 0):
        raise AssertionError("expected a Hopper card (9, 0), got %s" % (cap,))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip())
    return name


def phase_build():
    from parallel_nbody_tpu_torch.ops import _build
    t0 = time.perf_counter()
    lib = _build.load()
    seconds = time.perf_counter() - t0
    print("build: %.3f s to load (nvcc %.3f s): %s"
          % (seconds, lib.build_seconds, lib.path))
    if lib.build_log:
        print(lib.build_log.strip())
    return seconds


def _compare(label, rows, cols, dtype, biased, row_g0=0, col_g0=0):
    """Kernel vs plain version on the card; returns max |error|."""
    from parallel_nbody_tpu_torch.ops import cuda_step
    cfg = _cfg(str(dtype).replace("torch.", ""))
    got = cuda_step.block_forces(cfg, *rows, *cols, row_g0=row_g0,
                                 col_g0=col_g0, biased=biased)
    torch.cuda.synchronize()
    want = cuda_step.block_forces_reference(cfg, *rows, *cols, row_g0=row_g0,
                                            col_g0=col_g0, biased=biased)
    scale = max(float(w.abs().max()) for w in want)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    print("compare %-28s %s biased=%-5s max|err| %.6e  /max|F| %.6e"
          % (label, str(dtype).replace("torch.", ""), biased, err,
             err / scale))
    if not finite or not err <= TOL[dtype] * scale:
        raise AssertionError("%s: kernel disagrees with its plain version "
                             "(max|err| %.6e, max|F| %.6e, tol %.1e)"
                             % (label, err, scale, TOL[dtype]))
    return err


def phase_compare(dev):
    from parallel_nbody_tpu_torch.ops import cuda_step
    from parallel_nbody_tpu_torch.state import init_state, pad_state
    for dtype in (torch.float32, torch.float64):
        cfg = _cfg(str(dtype).replace("torch.", ""))
        for n in (1000, 4096, 4097):
            st = init_state(n, cfg, device=dev)
            b = (st.x, st.y, st.mass, st.radius)
            for biased in (True, False):
                _compare("glibc N=%d" % n, b, b, dtype, biased)
        st = init_state(4096, cfg, device=dev)
        rows = tuple(t[1000:3000].contiguous()
                     for t in (st.x, st.y, st.mass, st.radius))
        cols = tuple(t[2000:].contiguous()
                     for t in (st.x, st.y, st.mass, st.radius))
        for biased in (True, False):
            _compare("rect 2000x2096 g0=1000,2000", rows, cols, dtype, biased,
                     row_g0=1000, col_g0=2000)
        padded, _ = pad_state(init_state(1000, cfg, device=dev), 1152)
        mass = padded.mass.clone()
        mass[::7] = 0.0
        b = (padded.x, padded.y, mass, padded.radius)
        for biased in (True, False):
            _compare("zero-mass + far padding", b, b, dtype, biased)
        pair = [torch.tensor(v, dtype=dtype, device=dev)
                for v in ([100.0, 100.0], [200.0, 200.0], [5.0, 7.0],
                          [1.5, 1.5])]
        xf, yf = cuda_step.block_forces(cfg, *pair, *pair, biased=True)
        np.testing.assert_allclose(xf.cpu().numpy(), [KICK, -KICK],
                                   rtol=1e-6)
        np.testing.assert_array_equal(yf.cpu().numpy(), [0.0, 0.0])
        print("compare two-body kick        %s ok"
              % str(dtype).replace("torch.", ""))
    # The main path's shape and type: N=65536 fp32 from the glibc init.
    st = init_state(MAIN_N, _cfg("float32"), device=dev)
    b = (st.x, st.y, st.mass, st.radius)
    return max(_compare("main shape N=%d" % MAIN_N, b, b, torch.float32,
                        biased) for biased in (True, False))


def phase_coincident(dev):
    from parallel_nbody_tpu_torch.ops.cuda_step import any_coincident
    from parallel_nbody_tpu_torch.state import init_state, random_state
    cfg = _cfg("float32")
    st = init_state(4096, cfg, device=dev)
    flag = any_coincident(st.x, st.y, st.mass)
    if flag.device.type != "cuda" or not bool(flag):
        raise AssertionError("any_coincident missed the N=4096 glibc pairs")
    gen = torch.Generator(device=dev).manual_seed(0)
    st = random_state(4096, cfg, gen, device=dev)
    if bool(any_coincident(st.x, st.y, st.mass)):
        raise AssertionError("any_coincident flagged a random state")
    print("any_coincident: True on glibc N=4096, False on random_state")


def _cli(argv, platform):
    from parallel_nbody_tpu_torch import cli
    os.environ["NBODY_PLATFORM"] = platform
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["nbody"] + argv)
    if rc != 0:
        raise AssertionError("cli %s on %s exited %d:\n%s"
                             % (argv, platform, rc, err.getvalue()))
    return out.getvalue(), err.getvalue()


def _state_table(text, n):
    table = np.array([[float(v) for v in line.split()]
                      for line in text.splitlines()])
    if table.shape != (n, 6) or not np.isfinite(table).all():
        raise AssertionError("bad printed state, shape %s" % (table.shape,))
    return table


def _compare_tables(label, got, want, pos_tol, force_rel):
    for col, name in enumerate(("x", "y", "xf", "yf", "xv", "yv")):
        diff = np.abs(got[:, col] - want[:, col]).max()
        tol = (force_rel * np.abs(want[:, col]).max() if name in ("xf", "yf")
               else pos_tol)
        print("state %-22s %-2s max|diff| %.6e (tol %.6e)"
              % (label, name, diff, tol))
        if not diff <= tol:
            raise AssertionError("%s: field %s differs by %.6e"
                                 % (label, name, diff))


def phase_main_path(arena):
    from parallel_nbody_tpu_torch.ops import cuda_step
    from parallel_nbody_tpu_torch.utils.output import pair_interactions
    argv = [str(MAIN_N), "0", arena, str(MAIN_STEPS), "--no-clamp",
            "--pallas", "--run-xps"]
    cuda_step.block_forces.launches = 0
    out, err = _cli(argv, "cuda")
    launches = cuda_step.block_forces.launches
    row = re.fullmatch(r"%d,(\d+\.\d{3}), (\d+\.\d{2})\n" % MAIN_N, out)
    if row is None:
        raise AssertionError("malformed CSV row: %r" % out)
    if launches < MAIN_STEPS:
        raise AssertionError("main path launched the kernel %d times"
                             % launches)
    rtime = float(row.group(1))
    print("main path: %s" % " ".join(argv))
    print("main path: launches %d, RTIME %.3f s, %.6e unordered pairs/s, "
          "GFLOPS (reference model) %s"
          % (launches, rtime, pair_interactions(MAIN_N, MAIN_STEPS) / rtime,
             row.group(2)))
    sys.stderr.write(err)

    small = ["1024", "0", arena, "10", "--pallas"]
    card, _ = _cli(small, "cuda")
    card = _state_table(card, 1024)
    cpu32 = _state_table(_cli(small + ["--dtype=float32"], "cpu")[0], 1024)
    cpu64 = _state_table(_cli(small + ["--dtype=float64"], "cpu")[0], 1024)
    _compare_tables("N=1024 vs cpu fp32", card, cpu32, 2e-3, 1e-4)
    _compare_tables("N=1024 vs cpu fp64", card, cpu64, 5e-3, 1e-2)
    return launches, rtime


def _time_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_timing(dev):
    from parallel_nbody_tpu_torch.models.engine import run, step
    from parallel_nbody_tpu_torch.ops import cuda_step
    from parallel_nbody_tpu_torch.state import init_state
    from parallel_nbody_tpu_torch.utils.output import pair_interactions
    cfg = _cfg("float32")
    st = init_state(MAIN_N, cfg, device=dev)
    b = (st.x, st.y, st.mass, st.radius)
    off = torch.zeros((), dtype=torch.bool, device=dev)
    on = torch.ones((), dtype=torch.bool, device=dev)
    times = {
        "kernel": _time_ms(lambda: cuda_step.block_forces(
            cfg, *b, *b, biased=off), 20),
        "kernel_biased": _time_ms(lambda: cuda_step.block_forces(
            cfg, *b, *b, biased=on), 20),
        "plain": _time_ms(lambda: cuda_step.block_forces_reference(
            cfg, *b, *b, biased=off), 3, warmup=1),
        "any_coincident": _time_ms(lambda: cuda_step.any_coincident(
            st.x, st.y, st.mass), 20),
        "step": _time_ms(lambda: step(cfg, st), 20),
    }
    for name, ms in times.items():
        print("time N=%d fp32 %-15s %.6f ms" % (MAIN_N, name, ms))
    # The main path's loop, timed unrounded (the CLI prints RTIME to 1 ms).
    x0, y0 = st.x.clone(), st.y.clone()
    st = step(cfg, st)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = run(cfg, st, MAIN_STEPS)
    torch.cuda.synchronize()
    rtime = time.perf_counter() - t0
    if not all(bool(torch.isfinite(t).all()) for t in st):
        raise AssertionError("non-finite state after %d steps" % MAIN_STEPS)
    print("time engine.run N=%d x %d steps: %.6f s, %.6e unordered pairs/s"
          % (MAIN_N, MAIN_STEPS, rtime,
             pair_interactions(MAIN_N, MAIN_STEPS) / rtime))
    # Which kernel variant the steps took: the biased one runs while any
    # coincident pair remains.
    moved = int(((st.x != x0) | (st.y != y0)).sum())
    print("after %d steps: any_coincident=%s, %d of %d bodies moved off "
          "their initial position" % (MAIN_STEPS + 1, bool(
              cuda_step.any_coincident(st.x, st.y, st.mass)), moved, MAIN_N))
    return times


def main() -> int:
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device; this script runs only "
                         "on the card\n")
        return 1
    import parallel_nbody_tpu_torch  # noqa: F401  (fails outside the repo)
    from parallel_nbody_tpu_torch.utils import ppm

    dev = torch.device("cuda", 0)
    name = phase_device()
    phase_build()
    max_err = phase_compare(dev)
    phase_coincident(dev)
    with tempfile.TemporaryDirectory() as tmp:
        arena = os.path.join(tmp, "arena.ppm")
        ppm.create(arena, 1024, 768)
        launches, _ = phase_main_path(arena)
    times = phase_timing(dev)
    print(json.dumps({"kernels": [{
        "name": "block_forces_kernel",
        "route": "cuda",
        "source": "parallel_nbody_tpu_torch/csrc/forces.cu",
        "replaces": "parallel_nbody_tpu/ops/pallas_step.py:249",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": times["kernel"],
        "plain_ms": times["plain"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
