#!/usr/bin/env python3
"""Smoke run of parallel_nbody_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the CUDA force kernels from csrc/ (nvcc; K1 ``forces.cu`` and K2
``forces_streamed.cu``), holds each against its plain PyTorch version on the
card, drives the CLI's two single-device paths through the kernels (N=65536
for 100 steps through K1; N=262144 for 20 steps through K2 in fp32,
fp32 ``--accum=compensated`` and bf16), checks the printed state of a small
run against the CPU and two full-width steps against the plain version, and
times the kernels against their plain versions.  It also builds the probes
P1 (``roofline_probe.cu``) and P2 (``bias_variants_probe.cu``) beside the
force kernels, holds each of their 12 variants against its plain version,
and runs both probe drivers at N=65536 through their kernels.  K1 and K2
add the coincident kick through the TPU kernel's dx bias, segmented by
tile (csrc/pairs.cuh): both are also held against their plain versions on
blocks whose offsets are not multiples of 128, with coincident pairs placed
in a tile below, a tile above and both overlapping tiles.  The SASS census
tells K1's and K2's three fp32 pair loops apart (unbiased, constant bias,
per-pair bias), checks that none holds a per-pair branch or the rsqrtf
wrapper, and gives each kernel's issue bound.  Every phase passes or
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
  - probe kernels vs their plain versions, fp32 variants: 2e-5 * max|F| at
    N=4096 and 4e-5 at N=65536.  The probes' uniform inputs give sums with
    little cancellation (mem_only's and no_rsqrt's terms mostly share a
    sign), and a sequential fp32 sum of N same-signed terms errs by about
    sqrt(N)/6 * 2^-23 of the sum: 5e-6 at N=65536, so 4e-5 leaves 8 sigma.
  - the tensor-core variants (mxu2_r2, bias1_mxu2) round each term to tf32
    (2^-11 relative): per row |error_i| <= 2^-10 * |G m_i| * sum_j |term_ij|,
    the sum of magnitudes from the plain version.
"""

from __future__ import annotations

import concurrent.futures
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
PROBE_N, PROBE_STEPS = 65536, 20  # both probe drivers' defaults
TOL_PROBE_MAIN = 4e-5  # fp32 probe variants at PROBE_N (see the docstring)
TF32_REL = 2.0 ** -10
# Published peaks of one H100 SXM at 700 W: FP32 outside the tensor cores,
# and device memory.
PEAK_FP32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
# FP32 operations per pair of K1's unbiased loop, which P1 `full` and P2
# `r2` share (csrc/roofline_probe.cu): dx, dy, dsqr (3), ri + rj, its
# square, max, forced^2, * dsqr, the floor, mj * inv, two FMAs into the sums
# (4); the rsqrt runs on the MUFU.
FLOP_PER_PAIR = 16
# Coincident pairs (global ids) placed in an N=4096 glibc state for the
# block of rows 1000..2999 against columns 300..4095: row_g0 and col_g0 are
# not multiples of 128, so each 128-row block overlaps two 128-wide column
# tiles.  (1150, 1200): each term lies in one of the two tiles that overlap
# the block [1128, 1256); (1500, 2500): row 1500 sees body 2500 in a tile
# wholly above, row 2500 sees 1500 in a tile wholly below; (400, 1300): row
# 1300 sees body 400 in the tile [300, 428), wholly below.
PLACED_PAIRS = ((1150, 1200), (1500, 2500), (400, 1300))
PLACED_ROWS, PLACED_COLS = (1000, 3000), (300, 4096)
# The issue model of the pair loop: each SM has four schedulers, each
# issuing one warp instruction (32 pairs) per clock.
SCHEDULERS_PER_SM, WARP = 4, 32


def _cfg(dtype):
    from parallel_nbody_tpu_torch.config import SimConfig
    return SimConfig(force_mode="fast", dtype=dtype, kernel="cuda")


def _name(dtype):
    return str(dtype).replace("torch.", "")


def _bodies(st):
    return (st.x, st.y, st.mass, st.radius)


def phase_device():
    """Prints the card, its power limit and its issue rate; returns (name,
    warp instructions per second at the maximum SM clock)."""
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
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    sm_hz = float(clock.stdout.split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue_hz = SCHEDULERS_PER_SM * sms * sm_hz
    print("SMs %d, maximum SM clock %.0f MHz: %.6e warp instructions/s"
          % (sms, sm_hz / 1e6, issue_hz))
    return name, issue_hz


def phase_build():
    """Builds the force kernels and the probes side by side (two libraries,
    every source's nvcc started at once)."""
    from parallel_nbody_tpu_torch.ops import _build
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        libs = {name: pool.submit(_build.load, *args) for name, args in
                (("kernels", ()), ("probes", ("probes",)))}
        libs = {name: f.result() for name, f in libs.items()}
    seconds = time.perf_counter() - t0
    for name, lib in libs.items():
        print("build %s: nvcc %.3f s: %s" % (name, lib.build_seconds,
                                            lib.path))
        if lib.build_log:
            print(lib.build_log.strip())
    print("build: %.3f s to load both" % seconds)
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


def _placed_blocks(dtype, dev):
    """(rows, cols) of PLACED_ROWS x PLACED_COLS in an N=4096 glibc state
    with PLACED_PAIRS made coincident."""
    from parallel_nbody_tpu_torch.state import init_state
    st = init_state(4096, _cfg(_name(dtype)), device=dev)
    x, y = st.x.clone(), st.y.clone()
    for a, b in PLACED_PAIRS:
        x[b], y[b] = x[a], y[a]
    full = (x, y, st.mass, st.radius)
    return (tuple(t[slice(*PLACED_ROWS)].contiguous() for t in full),
            tuple(t[slice(*PLACED_COLS)].contiguous() for t in full))


def _compare_placed(dtype, dev, kernel, **kw):
    """The bias segments at misaligned offsets, both flags, both accums."""
    rows, cols = _placed_blocks(dtype, dev)
    for biased in (True, False):
        for accum in ("plain", "compensated"):
            _compare("placed pairs g0=%d,%d" % (PLACED_ROWS[0],
                                                PLACED_COLS[0]),
                     rows, cols, dtype, biased, row_g0=PLACED_ROWS[0],
                     col_g0=PLACED_COLS[0], kernel=kernel, accum=accum,
                     **kw)


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
        _compare_placed(dtype, dev, K1)
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
        _compare_placed(dtype, dev, K2, band=1024)
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


def _probe_inputs(n, seed, dev, square=False):
    """Eight fp32 vectors uniform in [1, 2) (as tests/torch_cases.py
    probe_inputs makes them): independent rows and columns, or with
    ``square`` columns equal to rows and bodies 7 and 300, 10 and 11 at one
    position."""
    rng = np.random.RandomState(seed)
    rows = [rng.uniform(1, 2, n).astype(np.float32) for _ in range(4)]
    cols = [rng.uniform(1, 2, n).astype(np.float32) for _ in range(4)]
    if square:
        for a, b in ((7, 300), (10, 11)):
            rows[0][b], rows[1][b] = rows[0][a], rows[1][a]
        cols = [a.copy() for a in rows]
    return [torch.from_numpy(a).to(dev) for a in rows + cols]


def _compare_probe(module, variant, args, label, tol, **tiles):
    """A probe kernel vs its plain version on the card.  Returns (max |error|,
    ms of the plain version's call)."""
    got = module.probe_forces(variant, *args, **tiles)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    *want, xmag, ymag = module.probe_forces_reference(
        variant, *args, magnitudes=True, **tiles)
    end.record()
    torch.cuda.synchronize()
    scale = max(float(w.abs().max()) for w in want)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    if variant in ("mxu2_r2", "bias1_mxu2"):
        # Per row, against the tf32 bound.
        worst = max(float(((g - w).abs() / (TF32_REL * m)).max())
                    for g, w, m in zip(got, want, (xmag, ymag)))
        ok, bound = worst <= 1.0, "%.3f of the tf32 bound" % worst
    else:
        ok, bound = err <= tol * scale, "tol %.0e" % tol
    print("compare %-19s %-11s %-22s max|err| %.6e /max|F| %.6e (%s)"
          % (module.NAME, variant, label, err, err / scale, bound))
    if not finite or not ok:
        raise AssertionError("%s %s %s: kernel disagrees with its plain "
                             "version (max|err| %.6e, max|F| %.6e)"
                             % (module.NAME, variant, label, err, scale))
    return err, start.elapsed_time(end)


def _run_probe_driver(module, argv, runs):
    """One probe driver in-process, its stdout captured, printed and
    parsed; its launch count set to 0 just before and checked just after.
    Returns ({variant: ms per step}, launches)."""
    module.probe_forces.launches = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = module.main(argv)
    launches = module.probe_forces.launches
    text = out.getvalue()
    print("driver: python -m parallel_nbody_tpu_torch.benchmarks.%s %s"
          % (module.NAME, " ".join(argv[1:])))
    print(text.rstrip())
    lines = text.splitlines()
    if rc != 0 or len(lines) != 1 + len(module.VARIANTS):
        raise AssertionError("%s exited %d with %d lines"
                             % (module.NAME, rc, len(lines)))
    ms = {}
    for variant, line in zip(module.VARIANTS, lines[1:]):
        row = re.fullmatch(r"(\S+) +(\d+\.\d{3}) ms/step +(\S+) pairs/s +"
                           r"\( *(\d+\.\d)% of (full|r2)\)", line)
        if row is None or row.group(1) != variant:
            raise AssertionError("%s: malformed line %r"
                                 % (module.NAME, line))
        ms[variant] = float(row.group(2))
    want = len(module.VARIANTS) * runs * int(argv[2])
    if launches != want:
        raise AssertionError("%s launched its kernel %d times, expected %d"
                             % (module.NAME, launches, want))
    return ms, launches


def phase_probes(dev):
    """P1 and P2: every variant's kernel against its plain version (N=4096
    independent, square with coincident bodies, and fed back; then the
    drivers' own inputs at N=65536), both drivers at N=65536, and K1 on the
    drivers' inputs in the same run."""
    from parallel_nbody_tpu_torch.benchmarks import _probe
    from parallel_nbody_tpu_torch.benchmarks import bias_variants_probe as p2
    from parallel_nbody_tpu_torch.benchmarks import roofline_probe as p1
    from parallel_nbody_tpu_torch.ops import cuda_step
    main = {}
    for module in (p1, p2):
        ind = _probe_inputs(4096, 0, dev)
        square = _probe_inputs(4096, 1, dev, square=True)
        big = _probe.inputs(PROBE_N, dev)
        for variant in module.VARIANTS:
            _compare_probe(module, variant, ind, "N=4096", TOL[torch.float32])
            _compare_probe(module, variant, square, "N=4096 square 128/256",
                           TOL[torch.float32], tile_i=128, tile_j=256)
            xf, yf = module.probe_forces_reference(variant, *ind)
            _compare_probe(module, variant, [xf, yf] + ind[2:],
                           "N=4096 fed back", TOL[torch.float32])
            main[module.NAME, variant] = _compare_probe(
                module, variant, big, "N=%d" % PROBE_N, TOL_PROBE_MAIN)
    ms1, launches1 = _run_probe_driver(
        p1, ["roofline_probe", str(PROBE_N), str(PROBE_STEPS)], runs=2)
    ms2, launches2 = _run_probe_driver(
        p2, ["bias_variants_probe", str(PROBE_N), str(PROBE_STEPS)], runs=4)
    cfg = _cfg("float32")
    big = _probe.inputs(PROBE_N, dev)
    off = torch.zeros((), dtype=torch.bool, device=dev)
    on = torch.ones((), dtype=torch.bool, device=dev)
    k1 = {"unbiased": _time_ms(lambda: cuda_step.block_forces(
              cfg, *big, biased=off), 20),
          "biased": _time_ms(lambda: cuda_step.block_forces(
              cfg, *big, biased=on), 20)}
    print("time N=%d on the probes' inputs: K1 unbiased %.6f ms, K1 biased "
          "%.6f ms; P1 full %.3f ms (%.4f of K1 unbiased); P2 r2 %.3f ms "
          "(%.4f of K1 unbiased)"
          % (PROBE_N, k1["unbiased"], k1["biased"], ms1["full"],
             ms1["full"] / k1["unbiased"], ms2["r2"],
             ms2["r2"] / k1["unbiased"]))
    # Each variant once more with CUDA events on the same inputs as K1 (no
    # feedback), so the probes and K1 compare on one footing.
    for module in (p1, p2):
        for variant in module.VARIANTS:
            ms = _time_ms(lambda: module.probe_forces(variant, *big), 10)
            print("time N=%d events %-19s %-11s %.6f ms (%.4f of K1 "
                  "unbiased)" % (PROBE_N, module.NAME, variant, ms,
                                 ms / k1["unbiased"]))
    return {"P1": dict(ms=ms1["full"], launches=launches1,
                       max_abs_err=main["roofline_probe", "full"][0],
                       plain_ms=main["roofline_probe", "full"][1]),
            "P2": dict(ms=ms2["r2"], launches=launches2,
                       max_abs_err=main["bias_variants_probe", "r2"][0],
                       plain_ms=main["bias_variants_probe", "r2"][1])}


def _sass_census():
    """The fp32 pair loops' instructions per pair (benchmarks/sass_census),
    with K1's and K2's three loops told apart.  Checks that each of those
    loops holds no FSETP (neither the old per-pair dsqr == 0 test nor the
    rsqrtf wrapper) and no branch but its own, and that the compiler kept
    the ablated probe loops' loads: `full`, `no_rsqrt` and `mem_only` read
    all four column values of each pair.  Returns {(kernel, role):
    instructions per pair} of K1's and K2's fp32 loops (plain accum)."""
    from parallel_nbody_tpu_torch.benchmarks import sass_census
    if sass_census.cuobjdump() is None:
        print("sass census: cuobjdump not found, skipped")
        return {}
    ipp = {}
    for lib in ("kernels", "probes"):
        rows = sass_census.census(sass_census.library_sass(lib))
        roles = sass_census.loop_roles(rows)
        for row in rows:
            name, start, _, pairs, ops = row
            if "<d" in name or "bfloat16" in name:
                continue  # the fp32 loops are the ones the probes ablate
            role = roles.get((name, start), "")
            print("sass census %s" % sass_census.format_row(row, role))
            if name.startswith(sass_census.FORCE_KERNELS):
                if not role or ops["FSETP"] or ops["BRA"] != 1:
                    raise AssertionError(
                        "%s loop %x (%s): FSETP %d, BRA %d"
                        % (name, start, role or "no role", ops["FSETP"],
                           ops["BRA"]))
                if name.endswith("<fLb0>"):
                    ipp[name.split("<")[0], role] = \
                        sass_census.instr_per_pair(row)
            if name in ("roofline_probe_kernel<Li0>",
                        "roofline_probe_kernel<Li1>",
                        "roofline_probe_kernel<Li3>") and \
                    sass_census.floats_loaded(ops) < 4 * pairs:
                raise AssertionError("%s: the compiler dropped column loads "
                                     "from the pair loop" % name)
    missing = [(k, r) for k in sass_census.FORCE_KERNELS
               for r in sass_census.ROLES if (k, r) not in ipp]
    if missing:
        raise AssertionError("sass census: no loop for %s" % missing)
    return ipp


def _issue_report(ipp, issue_hz, times, times_big):
    """Each force kernel's times at its main shape beside the issue bound of
    its loops (instructions per pair from the census, at the maximum SM
    clock), the biased/unbiased ratio, and the biased-unbiased gap beside
    any_coincident's time."""
    for kernel, label, n, t_off, t_on, t_any in (
            ("block_forces_kernel", "K1", MAIN_N, times["kernel"],
             times["kernel_biased"], times["any_coincident"]),
            ("band_partials_kernel", "K2", BIG_N, times_big["K2"],
             times_big["K2_biased"], times_big["any_coincident"])):
        warp_instr = n * n / WARP
        bound = {role: ipp[kernel, role] * warp_instr / issue_hz * 1e3
                 for role in ("unbiased", "constant bias")} if ipp else {}
        line = ("issue %s N=%d: unbiased %.6f ms, biased %.6f ms, "
                "biased/unbiased %.4f; gap %.6f ms beside any_coincident "
                "%.6f ms" % (label, n, t_off, t_on, t_on / t_off,
                             t_on - t_off, t_any))
        if bound:
            line += ("; issue bound unbiased %.3f instr/pair %.6f ms (%.1f%% "
                     "of the issue rate), constant bias %.3f instr/pair "
                     "%.6f ms (%.1f%%)"
                     % (ipp[kernel, "unbiased"], bound["unbiased"],
                        100 * bound["unbiased"] / t_off,
                        ipp[kernel, "constant bias"],
                        bound["constant bias"],
                        100 * bound["constant bias"] / t_on))
        print(line)


def _bound(n_rows, n_cols):
    """(bound_ms, bound_by) of one unbiased force pass over n_rows x n_cols
    pairs: FLOP_PER_PAIR FP32 operations per pair at the FP32 peak, against
    8 input vectors read once and 2 outputs written once (4 bytes each) at
    the memory rate."""
    t_ops = n_rows * n_cols * FLOP_PER_PAIR / PEAK_FP32_FLOPS
    t_bytes = 4 * (4 * n_rows + 4 * n_cols + 2 * n_rows) / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device; this script runs only "
                         "on the card\n")
        return 1
    import parallel_nbody_tpu_torch  # noqa: F401  (fails outside the repo)
    from parallel_nbody_tpu_torch.utils import ppm

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    name, issue_hz = phase_device()
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
    probes = phase_probes(dev)
    _issue_report(_sass_census(), issue_hz, times, times_big)
    print("chip_smoke: %.1f s" % (time.perf_counter() - t_start))
    source = "parallel_nbody_tpu_torch/csrc/%s"
    replaces = "parallel_nbody_tpu/ops/pallas_step.py:%d"
    kernels = [{
        "name": "block_forces_kernel",
        "route": "cuda",
        "source": source % "forces.cu",
        "replaces": replaces % 249,
        "launches": launches_k1,
        "max_abs_err": max_err_k1,
        "ms": times["kernel"],
        "ms_biased": times["kernel_biased"],
        "plain_ms": times["plain"],
        "n": MAIN_N,
    }, {
        "name": "band_partials_kernel+band_fold_kernel",
        "route": "cuda",
        "source": source % "forces_streamed.cu",
        "replaces": replaces % 344,
        "launches": launches_k2,
        "max_abs_err": max_err_k2,
        "ms": times_big["K2"],
        "ms_biased": times_big["K2_biased"],
        "plain_ms": plain_ms_k2,
        "n": BIG_N,
    }, dict(
        name="roofline_probe_kernel<full>",
        route="cuda",
        source=source % "roofline_probe.cu",
        replaces="benchmarks/roofline_probe.py:24",
        n=PROBE_N,
        **probes["P1"],
    ), dict(
        name="bias_probe_kernel<r2>",
        route="cuda",
        source=source % "bias_variants_probe.cu",
        replaces="benchmarks/bias_variants_probe.py:33",
        n=PROBE_N,
        **probes["P2"],
    )]
    for k in kernels:
        n = k.pop("n")
        k["bound_ms"], k["bound_by"] = _bound(n, n)
        k["library_ms"] = None  # no one PyTorch call computes these
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
