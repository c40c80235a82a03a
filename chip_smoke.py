#!/usr/bin/env python3
"""Smoke run of parallel_nbody_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the CUDA force kernels from csrc/ (nvcc; K1 ``forces.cu`` and K2
``forces_streamed.cu``), holds each against its plain PyTorch version on the
card, drives the CLI's two single-device paths through the kernels (N=65536
for 100 steps through K1; N=262144 for 20 steps through K2 in fp32,
fp32 ``--accum=compensated`` and bf16), checks the printed state of a small
run against the CPU and two full-width steps against the plain version, and
times the kernels against their plain versions.  Every phase passes or
raises: any failure exits non-zero before the result lines.  The last two
lines of stdout are the kernel table and the result, as JSON.

Tolerances (each comparison uses the plain version's max |F| as the scale):
  - kernel vs plain version, fp32: 2e-5 * max|F| up to N=65536.  The
    kernels sum each row sequentially in fp32 (error grows like sqrt(N): an
    emulation on the CPU gave 8e-7 of max|F| at N=4097 and 1.8e-6 at
    N=16384, and K1 measured 4.9e-6 at N=65536 on the H100); rsqrtf adds
    2 ulp per term.  At N=262144 the same growth gives ~1e-5, so 4e-5.
  - kernel vs plain version, fp64: 1e-12 * max|F| (the same sums in fp64).
  - compensated: the magnitude-spread case of tests/test_accum.py (plain
    error > 5e-7, compensated < 3e-7 of the exact sum), and the compensated
    kernels against their compensated plain versions as above.
  - bf16 storage: each kernel's bf16 output is bit-equal to its fp32 output
    on the upcast inputs, rounded once to bf16 (the kernels compute in fp32).
  - the N=1024, 10-step CLI run on the card (fp32) against the same run on
    the CPU in fp32: positions and velocities within 2e-3 (two units of the
    printed %.3f), forces within 1e-4 * max|F|; against the CPU in fp64:
    positions and velocities within 5e-3, forces within 1e-2 * max|F|.
    fp32 positions quantize at ~6e-5 near x=1000 while a body moves ~2.5e-5
    per step, so close pairs' forces drift from the fp64 run by up to 0.4%
    of max|F| in 10 steps (measured on the CPU).
  - two engine steps at N=262144 through K2 against the same steps with the
    plain version's forces: the first force pass differs by the kernel's
    4e-5 * max|F| at most; the second starts from positions that may differ
    by an fp32 ulp, which moves close pairs' terms.  Positions within 1e-3
    (one printed unit), velocities and forces within 1e-3 of the field's
    max.
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
from unittest import mock

import numpy as np
import torch

KICK = 38.5 / 9.0  # G * 5 * 7 / (1.5 + 1.5)^2
TOL = {torch.float32: 2e-5, torch.float64: 1e-12}
TOL_BIG = 4e-5  # fp32 at N=262144 (see the docstring)
MAIN_N, MAIN_STEPS = 65536, 100  # K1's path
BIG_N, BIG_STEPS = 262144, 20  # K2's path: above cuda_step.STREAMED_ABOVE
BIG_RUNS = (("fp32", []), ("fp32 compensated", ["--accum=compensated"]),
            ("bf16", ["--dtype=bfloat16"]))
K1, K2 = "block_forces", "block_forces_streamed"


def _cfg(dtype):
    from parallel_nbody_tpu_torch.config import SimConfig
    return SimConfig(force_mode="fast", dtype=dtype, kernel="cuda")


def _name(dtype):
    return str(dtype).replace("torch.", "")


def _bodies(st):
    return (st.x, st.y, st.mass, st.radius)


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


def _compare(label, rows, cols, dtype, biased, row_g0=0, col_g0=0,
             kernel=K1, tol=None, **kw):
    """Kernel vs plain version on the card; returns (max |error|, ms of the
    plain version's call).  ``kw`` goes to both (band, accum)."""
    from parallel_nbody_tpu_torch.ops import cuda_step
    cfg = _cfg(_name(dtype))
    call = dict(row_g0=row_g0, col_g0=col_g0, biased=biased, **kw)
    got = getattr(cuda_step, kernel)(cfg, *rows, *cols, **call)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = getattr(cuda_step, kernel + "_reference")(cfg, *rows, *cols,
                                                     **call)
    end.record()
    torch.cuda.synchronize()
    scale = max(float(w.abs().max()) for w in want)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    tol = TOL[dtype] if tol is None else tol
    print("compare %-2s %-34s %s biased=%-5s %-11s max|err| %.6e  "
          "/max|F| %.6e" % ("K1" if kernel == K1 else "K2", label,
                            _name(dtype), bool(biased),
                            kw.get("accum", "plain"), err, err / scale))
    if not finite or not err <= tol * scale:
        raise AssertionError("%s %s: kernel disagrees with its plain version "
                             "(max|err| %.6e, max|F| %.6e, tol %.1e)"
                             % (kernel, label, err, scale, tol))
    return err, start.elapsed_time(end)


def _two_body_kick(kernel, dtype, dev, **kw):
    from parallel_nbody_tpu_torch.ops import cuda_step
    pair = [torch.tensor(v, dtype=dtype, device=dev)
            for v in ([100.0, 100.0], [200.0, 200.0], [5.0, 7.0],
                      [1.5, 1.5])]
    xf, yf = getattr(cuda_step, kernel)(_cfg(_name(dtype)), *pair, *pair,
                                        biased=True, **kw)
    np.testing.assert_allclose(xf.cpu().numpy(), [KICK, -KICK], rtol=1e-6)
    np.testing.assert_array_equal(yf.cpu().numpy(), [0.0, 0.0])
    print("compare %-2s two-body kick %s ok"
          % ("K1" if kernel == K1 else "K2", _name(dtype)))


def phase_compare(dev):
    from parallel_nbody_tpu_torch.state import init_state, pad_state
    for dtype in (torch.float32, torch.float64):
        cfg = _cfg(_name(dtype))
        for n in (1000, 4096, 4097):
            st = init_state(n, cfg, device=dev)
            b = _bodies(st)
            for biased in (True, False):
                _compare("glibc N=%d" % n, b, b, dtype, biased)
        st = init_state(4096, cfg, device=dev)
        rows = tuple(t[1000:3000].contiguous() for t in _bodies(st))
        cols = tuple(t[2000:].contiguous() for t in _bodies(st))
        for biased in (True, False):
            _compare("rect 2000x2096 g0=1000,2000", rows, cols, dtype, biased,
                     row_g0=1000, col_g0=2000)
        padded, _ = pad_state(init_state(1000, cfg, device=dev), 1152)
        mass = padded.mass.clone()
        mass[::7] = 0.0
        b = (padded.x, padded.y, mass, padded.radius)
        for biased in (True, False):
            _compare("zero-mass + far padding", b, b, dtype, biased)
        _two_body_kick(K1, dtype, dev)
    # The main path's shape and type: N=65536 fp32 from the glibc init.
    st = init_state(MAIN_N, _cfg("float32"), device=dev)
    b = _bodies(st)
    return max(_compare("main shape N=%d" % MAIN_N, b, b, torch.float32,
                        biased)[0] for biased in (True, False))


def phase_compare_streamed(dev):
    """K2 against its plain version: several bands with a ragged tail, a
    rectangular block whose offsets put band edges inside it, zero-mass and
    far padding, the two-body kick, and the main shape once.  Returns
    (max |error| at the main shape, the plain version's ms there)."""
    from parallel_nbody_tpu_torch.state import init_state, pad_state
    for dtype in (torch.float32, torch.float64):
        cfg = _cfg(_name(dtype))
        b = _bodies(init_state(4097, cfg, device=dev))
        for biased in (True, False):
            for accum in ("plain", "compensated"):
                _compare("glibc N=4097 band 1024", b, b, dtype, biased,
                         kernel=K2, band=1024, accum=accum)
        # Rows are bodies 1000..2999, columns 500..4095: the column bands
        # start at bodies 1524, 2548 and 3572, two of them inside the rows.
        st = init_state(4096, cfg, device=dev)
        rows = tuple(t[1000:3000].contiguous() for t in _bodies(st))
        cols = tuple(t[500:].contiguous() for t in _bodies(st))
        for biased in (True, False):
            _compare("rect 2000x3596 g0=1000,500 band 1024", rows, cols,
                     dtype, biased, row_g0=1000, col_g0=500, kernel=K2,
                     band=1024)
        padded, _ = pad_state(init_state(1000, cfg, device=dev), 1152)
        mass = padded.mass.clone()
        mass[::7] = 0.0
        b = (padded.x, padded.y, mass, padded.radius)
        for biased in (True, False):
            _compare("zero-mass + far padding band 256", b, b, dtype, biased,
                     kernel=K2, band=256)
        _two_body_kick(K2, dtype, dev)
    # The main path's shape and type: N=262144 fp32, band 65536 (4 bands).
    b = _bodies(init_state(BIG_N, _cfg("float32"), device=dev))
    return _compare("main shape N=%d" % BIG_N, b, b, torch.float32, False,
                    kernel=K2, tol=TOL_BIG)


def phase_compensated(dev):
    """The magnitude-spread case of tests/test_accum.py through both
    kernels (the Kahan folds survive the compiler), and the compensated
    kernels against their plain versions at N=16384."""
    from parallel_nbody_tpu_torch.ops import cuda_step
    from parallel_nbody_tpu_torch.state import init_state
    cfg = _cfg("float32")
    n_cols = 4096
    mj = torch.full((n_cols,), 0.9 / 128, dtype=torch.float32, device=dev)
    mj[0] = 2.0 ** 24

    def const(n, v):
        return torch.full((n,), v, dtype=torch.float32, device=dev)

    args = (const(1, 0.0), const(1, 0.0), const(1, 1.0), const(1, 0.1),
            const(n_cols, 1.0), const(n_cols, 0.0), mj, const(n_cols, 0.1))
    exact = 1.1 * (2.0 ** 24 + (n_cols - 1) * (0.9 / 128))
    for kernel, kw in ((K1, {}), (K2, dict(band=128))):
        err = {}
        for accum in ("plain", "compensated"):
            fx, _ = getattr(cuda_step, kernel)(cfg, *args, row_g0=0,
                                               col_g0=8192, biased=False,
                                               accum=accum, **kw)
            err[accum] = abs(float(fx[0]) - exact) / exact
        print("magnitude spread %s: relative error plain %.6e, compensated "
              "%.6e" % (kernel, err["plain"], err["compensated"]))
        if not (err["plain"] > 5e-7 and err["compensated"] < 3e-7):
            raise AssertionError("%s: compensation lost (%s)" % (kernel, err))
    b = _bodies(init_state(16384, cfg, device=dev))
    for biased in (True, False):
        _compare("glibc N=16384", b, b, torch.float32, biased,
                 accum="compensated")
        _compare("glibc N=16384 band 4096", b, b, torch.float32, biased,
                 kernel=K2, band=4096, accum="compensated")


def phase_bf16(dev):
    """bf16 storage: each kernel's bf16 output is bit-equal to its fp32
    output on the upcast inputs, rounded once."""
    from parallel_nbody_tpu_torch.ops import cuda_step
    from parallel_nbody_tpu_torch.state import init_state
    cases = [(K1, 4097, {}), (K2, 4097, dict(band=1024)), (K2, BIG_N, {})]
    for kernel, n, kw in cases:
        b16 = _bodies(init_state(n, _cfg("bfloat16"), device=dev))
        b32 = tuple(t.float() for t in b16)
        fn = getattr(cuda_step, kernel)
        for biased in (True, False):
            for accum in ("plain", "compensated"):
                got = fn(_cfg("bfloat16"), *b16, *b16, biased=biased,
                         accum=accum, **kw)
                want = fn(_cfg("float32"), *b32, *b32, biased=biased,
                          accum=accum, **kw)
                for g, w in zip(got, want):
                    if g.dtype != torch.bfloat16 or not torch.equal(
                            g, w.to(torch.bfloat16)):
                        raise AssertionError(
                            "%s bf16 N=%d biased=%s %s: not the fp32 result "
                            "rounded once" % (kernel, n, biased, accum))
        print("bf16 %-21s N=%d: bit-equal to fp32 rounded once (both flags, "
              "both accums)" % (kernel, n))


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


def _xps_run(n, steps, extra, arena):
    """One ``--run-xps`` CLI run on the card with both kernels' counts set
    to 0 just before it; returns (K1 launches, K2 launches, RTIME)."""
    from parallel_nbody_tpu_torch.ops import cuda_step
    from parallel_nbody_tpu_torch.utils.output import pair_interactions
    argv = [str(n), "0", arena, str(steps), "--no-clamp", "--pallas",
            "--run-xps"] + extra
    cuda_step.block_forces.launches = 0
    cuda_step.block_forces_streamed.launches = 0
    out, err = _cli(argv, "cuda")
    k1 = cuda_step.block_forces.launches
    k2 = cuda_step.block_forces_streamed.launches
    row = re.fullmatch(r"%d,(\d+\.\d{3}), (\d+\.\d{2})\n" % n, out)
    if row is None:
        raise AssertionError("malformed CSV row: %r" % out)
    rtime = float(row.group(1))
    print("main path: %s" % " ".join(argv))
    print("main path: launches K1 %d K2 %d, RTIME %.3f s, %.6e unordered "
          "pairs/s, GFLOPS (reference model) %s"
          % (k1, k2, rtime, pair_interactions(n, steps) / rtime,
             row.group(2)))
    sys.stderr.write(err)
    return k1, k2, rtime


def phase_main_path(arena):
    k1, k2, rtime = _xps_run(MAIN_N, MAIN_STEPS, [], arena)
    if k1 < MAIN_STEPS or k2 != 0:
        raise AssertionError("N=%d path launched K1 %d and K2 %d times"
                             % (MAIN_N, k1, k2))

    small = ["1024", "0", arena, "10", "--pallas"]
    card, _ = _cli(small, "cuda")
    card = _state_table(card, 1024)
    cpu32 = _state_table(_cli(small + ["--dtype=float32"], "cpu")[0], 1024)
    cpu64 = _state_table(_cli(small + ["--dtype=float64"], "cpu")[0], 1024)
    _compare_tables("N=1024 vs cpu fp32", card, cpu32, 2e-3, 1e-4)
    _compare_tables("N=1024 vs cpu fp64", card, cpu64, 5e-3, 1e-2)
    return k1, rtime


def phase_main_path_streamed(arena):
    """The slice's path: N=262144 through K2 in fp32, fp32 compensated and
    bf16.  Returns K2's launches over the three runs."""
    total = 0
    for label, extra in BIG_RUNS:
        k1, k2, _ = _xps_run(BIG_N, BIG_STEPS, extra, arena)
        if k2 < BIG_STEPS or k1 != 0:
            raise AssertionError("N=%d %s path launched K1 %d and K2 %d "
                                 "times" % (BIG_N, label, k1, k2))
        total += k2
    return total


def phase_state_streamed(dev):
    """Two engine steps at N=262144 through K2 against the same two steps
    with forces from K2's plain version on the card."""
    from parallel_nbody_tpu_torch.models import engine
    from parallel_nbody_tpu_torch.ops import cuda_step
    from parallel_nbody_tpu_torch.state import init_state

    def plain_forces(cfg, x, y, mass, radius, *, biased, accum):
        return cuda_step.block_forces_streamed_reference(
            cfg, x, y, mass, radius, x, y, mass, radius, biased=biased,
            accum=accum)

    cfg = _cfg("float32")
    st0 = init_state(BIG_N, cfg, device=dev)
    before = cuda_step.block_forces_streamed.launches
    got = engine.run(cfg, st0, 2)
    if cuda_step.block_forces_streamed.launches != before + 2:
        raise AssertionError("engine.step at N=%d did not launch K2" % BIG_N)
    with mock.patch.object(engine, "cuda_forces", plain_forces):
        want = engine.run(cfg, st0, 2)
    torch.cuda.synchronize()
    for name in ("x", "y", "xv", "yv", "xf", "yf"):
        g, w = getattr(got, name), getattr(want, name)
        if not bool(torch.isfinite(g).all()):
            raise AssertionError("non-finite %s after 2 steps" % name)
        diff = float((g - w).abs().max())
        tol = 1e-3 if name in ("x", "y") else 1e-3 * float(w.abs().max())
        print("state N=%d 2 steps K2 vs plain %-2s max|diff| %.6e (tol %.6e)"
              % (BIG_N, name, diff, tol))
        if not diff <= tol:
            raise AssertionError("N=%d: field %s differs by %.6e"
                                 % (BIG_N, name, diff))


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
    b = _bodies(st)
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


def phase_timing_streamed(dev):
    """K2 at N=262144 (unbiased, biased, compensated, bf16), its fold
    launch alone, K1 at the same N, and the step."""
    from parallel_nbody_tpu_torch.models.engine import step
    from parallel_nbody_tpu_torch.ops import cuda_step
    from parallel_nbody_tpu_torch.state import init_state
    cfg, cfg16 = _cfg("float32"), _cfg("bfloat16")
    st = init_state(BIG_N, cfg, device=dev)
    b = _bodies(st)
    b16 = tuple(t.to(torch.bfloat16) for t in b)
    off = torch.zeros((), dtype=torch.bool, device=dev)
    on = torch.ones((), dtype=torch.bool, device=dev)
    ws = torch.randn((BIG_N // cuda_step.STREAM_BAND, 2, BIG_N),
                     dtype=torch.float32, device=dev)

    def k2(bodies, c, biased, accum="plain"):
        return lambda: cuda_step.block_forces_streamed(
            c, *bodies, *bodies, biased=biased, accum=accum)

    times = {
        "K2": _time_ms(k2(b, cfg, off), 5, warmup=1),
        "K2_biased": _time_ms(k2(b, cfg, on), 5, warmup=1),
        "K2_compensated": _time_ms(k2(b, cfg, off, "compensated"), 5,
                                   warmup=1),
        "K2_biased_compensated": _time_ms(k2(b, cfg, on, "compensated"), 5,
                                          warmup=1),
        "K2_bf16": _time_ms(k2(b16, cfg16, off), 5, warmup=1),
        "K2_bf16_biased": _time_ms(k2(b16, cfg16, on), 5, warmup=1),
        "fold": _time_ms(lambda: cuda_step.band_fold(cfg, ws, st.mass), 50),
        "K1": _time_ms(lambda: cuda_step.block_forces(
            cfg, *b, *b, biased=off), 5, warmup=1),
        "K1_biased": _time_ms(lambda: cuda_step.block_forces(
            cfg, *b, *b, biased=on), 5, warmup=1),
        "any_coincident": _time_ms(lambda: cuda_step.any_coincident(
            st.x, st.y, st.mass), 20),
        "step": _time_ms(lambda: step(cfg, st), 5, warmup=1),
    }
    for name, ms in times.items():
        print("time N=%d %-22s %.6f ms" % (BIG_N, name, ms))
    return times


def main() -> int:
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device; this script runs only "
                         "on the card\n")
        return 1
    import parallel_nbody_tpu_torch  # noqa: F401  (fails outside the repo)
    from parallel_nbody_tpu_torch.utils import ppm

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    name = phase_device()
    phase_build()
    max_err_k1 = phase_compare(dev)
    max_err_k2, plain_ms_k2 = phase_compare_streamed(dev)
    phase_compensated(dev)
    phase_bf16(dev)
    phase_coincident(dev)
    with tempfile.TemporaryDirectory() as tmp:
        arena = os.path.join(tmp, "arena.ppm")
        ppm.create(arena, 1024, 768)
        launches_k1, _ = phase_main_path(arena)
        launches_k2 = phase_main_path_streamed(arena)
    phase_state_streamed(dev)
    times = phase_timing(dev)
    times_big = phase_timing_streamed(dev)
    print("chip_smoke: %.1f s" % (time.perf_counter() - t_start))
    source = "parallel_nbody_tpu_torch/csrc/%s"
    replaces = "parallel_nbody_tpu/ops/pallas_step.py:%d"
    print(json.dumps({"kernels": [{
        "name": "block_forces_kernel",
        "route": "cuda",
        "source": source % "forces.cu",
        "replaces": replaces % 249,
        "launches": launches_k1,
        "max_abs_err": max_err_k1,
        "ms": times["kernel"],
        "plain_ms": times["plain"],
    }, {
        "name": "band_partials_kernel+band_fold_kernel",
        "route": "cuda",
        "source": source % "forces_streamed.cu",
        "replaces": replaces % 344,
        "launches": launches_k2,
        "max_abs_err": max_err_k2,
        "ms": times_big["K2"],
        "plain_ms": plain_ms_k2,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
