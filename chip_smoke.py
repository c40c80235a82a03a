#!/usr/bin/env python3
"""Smoke run of parallel_nbody_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the CUDA force kernels from csrc/ (nvcc; K1 ``forces.cu``, the
symmetric pass ``forces_symmetric.cu`` and K2 ``forces_streamed.cu``), holds
each against its plain PyTorch version on the card, drives the CLI's two single-device paths through the kernels (N=65536
for 100 steps through K1; N=262144 for 20 steps through K2 in fp32,
fp32 ``--accum=compensated`` and bf16), checks the printed state of a small
run against the CPU and two full-width steps against the plain version, and
times the kernels against their plain versions.  It also builds the probes
P1 (``roofline_probe.cu``) and P2 (``bias_variants_probe.cu``) beside the
force kernels, prints the layout of their row loops as built (rows per
thread, column split, the cluster fold, registers), holds each of their 12
variants against its plain version in the kernel's summation order
(including n = 384 and 1152, which neither the row block nor the split
divides), and runs both probe drivers at N=65536 through their kernels.
K1 and K2 add the coincident kick through the TPU kernel's dx bias,
segmented by tile (csrc/pairs.cuh): both are also held against their plain
versions on blocks whose offsets are not multiples of 128, with coincident
pairs placed in a tile below, a tile above and both overlapping tiles.
The symmetric pass (K1's square fp32 case, each unordered pair once; the
fp32 main path to 131072 bodies) is held to its plain version at N=384,
4097, 65536 and 131072, two passes bit-equal, the kick of each placed pair
bit-equal to K1's and far padding exactly 0 (phase_symmetric), and timed
beside K1 on the same bodies at 65536 and 131072.
The parity pass (``forces_trig.cu``, its own library: float64, the
reference's trig pair math in its per-body order) is held bit for bit to the
dense trig path and to its plain version at N=2, 1000, 4096 and 10000 (the
glibc init and random_state), two passes bit-equal, and to its plain version
at 65536, then timed at N=10000 and 65536 beside the dense path at 10000
(phase_trig); the CLI's ``65536 0 arena 3 --no-clamp --pallas --trig``
launches it once a step and once to warm up, no other force kernel, and
prints the bytes of the same run with the plain version's forces
(phase_main_path_trig, the kernel line's ``launches``).
The SASS census tells K1's and K2's three fp32 pair loops apart (unbiased,
constant bias, per-pair bias), and the symmetric kernel's two loops from its
diagonal's three, checks that none holds a per-pair branch or
the rsqrtf wrapper, checks the probe loops (no FSETP, a pass of R rows,
every column load kept), and gives each kernel's issue bound.

The rest of what the CLI does on one device runs at N=65536 in fp32 on the
1024x768 arena: a sabotage case (K1 against a plain version with gravity's
sign flipped must FAIL its comparison); the rasterizer on the card against
the same tensors rendered on the CPU and against a second chunking
(byte-equal), with its time and peak memory; the CLI with
``secs_per_update=1`` for 2000 steps (frames drawn as its RTIME calls for,
K1's launches accounted for, the printed state byte-equal to the same run
without frames); ``--checkpoint`` at 60 steps and ``--resume`` to 100
(stdout byte-equal to the uninterrupted run; a resume past the target runs
no step and records step 60); and at N=4096 ``--check-nans`` (clean, and a
planted NaN) and ``--trace`` (a trace with device time, a 0.00% collective
share).  The earlier phases run at the depth they had.

K1 in fp64 against the reference binary's own bytes (phase_reference_replay,
after them): the 203 distinct outputs of the reference binary that the JAX
repo's fuzz sweeps cached in tests_out/fuzz*/ (N 2-254, 38010 steps), the
golden fixtures of at most 1000 steps (8; REF_OUTPUT's 100000 are left out)
and the 45 two-leg resume records of tests_out/fuzz_resume*, each through
the CLI in-process with ``--pallas --dtype=float64`` (K1's fp64
instantiation with the any_coincident dispatch) on the card, a .npz
checkpoint at a resume's split: stdout byte-equal to the oracle, K1
launched once a step and once for each run's warm-up (48654 launches).  One
run is known to differ and is pinned, not passed: K1's fast formula prints
seq_10000_100.out's line 8345 one force digit off the reference
(REPLAY_KNOWN_MISS); the JAX package's Pallas kernel does the same, and the
dense trig path prints that fixture's bytes (tests/test_torch_gpu.py).
Then the same oracles, fixtures and resume records through the parity
spelling, ``--pallas --trig`` (the parity pass, float64): stdout byte-equal
to every one, seq_10000_100.out's line 8345 included, the parity pass
launched once a step and once for each run's warm-up and K1 never.

The distributed programs (parallel_nbody_tpu_torch/parallel/):
  - A. World size 1 on NCCL (a process group of this process alone): the
    all-gather and ring programs and the 1x1 grid, N=65536 fp32 through the
    symmetric pass for 100 steps from the CLI's glibc init, each bit-equal
    to engine.run with one force pass a step, their unordered pairs/s beside
    engine.run's; fp64 trig at N=1024, the printout byte-equal.
  - B. The ranks emulated on the card (parallel/emulate.py): for 2 and 4
    all-gather and ring ranks and the grids 2x2, 1x4 and 4x1 at N=65536,
    every rank's force computation through K1 at its offsets against the
    same rank through the plain version, the ranks together against the
    single-device K1 pass, and each rank's time; K2 through 2 all-gather
    ranks at N=262144.  The state is random_state with one pair made
    coincident across the middle, so the ranks' tagged flags differ.  Then
    the sabotage: rank 1's row_g0 one tile low must fail.
  - C. The CLI's spawned gloo ranks on this machine's CPU and torch, fp64
    trig (N=97, 100 steps; --devices=4, --comm=ring, --mesh2d=2x2), two
    ranks' directory checkpoint at 60 steps resumed by one rank, and
    ``parallel.dryrun 4``: each printout byte-equal to one rank's; they run
    in subprocesses beside the first phases, each killed at 300 s.  On the
    card ``--devices=2`` exits 1 with the mesh message (one card; NCCL
    takes one rank per card).
  - D. ``--checkpoint`` into a directory at world size 1 on the card at 60
    steps and ``--resume`` to 100: stdout byte-equal to 100 uninterrupted.

The accuracy tools and entry points, last, each with its wall time and its
kernel launches (the counts set to 0 just before it):
  - hw_validate: ``benchmarks/hw_validate.run_gate`` at its full sizes,
    cases A, F, B, B', R0-R2, C, D, D', E and the gravity-flip sabotage
    against float64, one line per case with its worst error beside its
    tolerance (the JAX gate's, stated in that module); K1 100 and K2 142
    launches.
  - drift: ``benchmarks/drift_study.run_study`` at N=65536 for fp32 plain,
    fp32 compensated and bf16, 1000 steps deep (the energy at 0, 500 and
    1000; the full 5000 steps are run by hand).
  - animate: ``examples/animate.record`` at N=4096, 200 steps recorded
    every 50 on the card.
  - entry: ``entry()``'s fn on the card, one step.

The speed tools (``benchmarks/``), after them, with the same accounting:
  - bench: the headline benchmark in-process, its one JSON line parsed
    (the root bench.py's keys and a fingerprint of this card), K1 launched
    (1 + REPS) * STEPS times;
  - perf gate: that line PASSes the floor, and the gate's own subprocess
    run of the benchmark with the sabotage (the force pass in K1 launches
    of 8192 rows) trips it;
  - scaling: ``run_benchmarks`` in full — seq_grid, the K1/K2 grid to
    N=2097152 with K2's first pass held to its plain version on 4096 rows
    at 1M and 2M (``HOLD_TOL``), and the shard grid's reason for skipping
    on one card;
  - K2 probes: ``ring_bias_probe``, ``bf16_stream_probe`` and a subset of
    ``autotune`` at one repetition;
  - huge_n: its argv ``N row_chunk out.ppm`` at N=1048576 with the default
    row chunk: one step through K2 in 3 row chunks, and its frame.

The huge-N path (phase_hosted), last, with the same accounting:
  - (a) N=2^21 from random_state: engine.step (one K2 launch, a 512 MiB
    workspace) against ``engine.make_hosted_row_step`` in chunks of 262144
    rows (8 launches, 64 MiB each), bit-equal, each one's peak memory;
    then render_frame against render_frame_hosted, byte-equal, with theirs.
  - (b) N=26,000,000: one launch's workspace beside the card's
    total_memory, and the launches engine.step takes at that N (its rows
    sized by K2_WORKSPACE_BYTES); one K2 row chunk of 524288 rows at
    row_g0=13,000,000 against all columns, its time and peak memory, its
    first 128 rows bit-equal to K2 on those rows alone and 8 rows against
    the plain version; then render_frame against render_frame_hosted on
    the 26M bodies, byte-equal, with their times and peaks.  The whole
    step at that N is run by hand (benchmarks/huge_n).
  - (c) the CLI at N=262144, ``secs_per_update=1``, 3 steps, without and
    with NBODY_HUGE_THRESHOLD=131072 (and K2_WORKSPACE_BYTES lowered to
    hold 65536 rows a launch): stdout byte-equal, the first frame's md5
    equal, K2 launched 3 + 1 (the warm-up step) and 3 x 4 times (no
    discarded step).

Every phase passes or raises: any failure exits non-zero before the result
lines.  The last two lines of stdout are the kernel table and the result,
as JSON.

Tolerances (each comparison uses the plain version's max |F| as the scale):
  - kernel vs plain version, fp32: 2e-6 * max|F| at every N here.  Both
    sum each 128-column tile into a partial and fold the partials in the
    same order (in K2 within each band, then the bands in order); they
    differ only inside a tile, where the kernel adds term by term and the
    plain version sums as ``torch.sum`` does, and in nothing else (the
    bare MUFU rsqrt returns ``torch.rsqrt``'s bits on these arguments).
    The difference is a sum of N/128 per-tile differences of a few ulps
    of a tile's partial, so it grows like sqrt(N/128): on the H100 K1
    measured 1.8e-7 of max|F| at N=4096 and 2.7e-7 at N=65536, K2
    2.8e-7 at N=262144, so 2e-6 leaves a factor of 7.  (When K1 summed a
    row's terms one by one into a single fp32 sum, the bound was 2e-5 to
    N=65536 and 4e-5 at N=262144.)
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
    2e-6 * max|F| at most; the second starts from positions that may differ
    by an fp32 ulp, which moves close pairs' terms.  Positions within 1e-3
    (one printed unit), velocities and forces within 1e-3 of the field's
    max.
  - probe kernels vs their plain versions in the kernels' order (column
    parts, each summed in order, folded in rank order), fp32 variants:
    2e-5 * max|F| up to N=4096 and 4e-5 at N=65536 (``TOL_PROBE``,
    ``TOL_PROBE_MAIN``; the probe kernels did not change).  The probes'
    uniform inputs give sums with little cancellation (mem_only's and no_rsqrt's
    terms mostly share a sign), and a sequential fp32 sum of N same-signed terms errs by about
    sqrt(N)/6 * 2^-23 of the sum: 5e-6 at N=65536, so 4e-5 leaves 8 sigma.
  - the tensor-core variants (mxu2_r2, bias1_mxu2) round each term to tf32
    (2^-11 relative): per row |error_i| <= 2^-10 * |G m_i| * sum_j |term_ij|,
    the sum of magnitudes from the plain version.
  - frames: none; card and CPU frames are byte-equal.  Each pixel's test is
    ``sqrt(dx*dx + dy*dy) <= radius + 0.5`` in fp32 with one rounding per
    operation on both devices: subtraction, multiplication, addition and
    ``torch.sqrt`` are correctly rounded on both, and eager ops are separate
    kernels, so nothing is contracted into an FMA.
  - the symmetric pass vs its plain version, fp32: 2e-6 * max|F| (measured
    1.8-2.1e-7 on the H100 from 384 to 131072 bodies): the same terms, each
    tile pair's sums and then each body's tile slots in tile order, where
    the kernel sums a 128-column block of a row's terms one by one and a
    column's terms by rows, lanes and warps.
  - frames, checkpoints and resume leave the printed state byte-equal: K1
    and the symmetric pass sum in a fixed order with no atomics, and the .npz holds the
    fp32 state exactly (as float64).
  - world size 1 (A): bit-equal.  The programs make engine.step's call (the
    same offsets and shapes, and one block handed as the same tensors, so
    the symmetric pass), the tagged flag equals any_coincident's, the
    ring makes no hop and the all-reduce is over one rank.
  - emulated ranks (B): each rank's kernel call against its plain version
    as above (2e-6 * max|F|); the ranks together against the single-device
    pass at the same bound: that pass is the symmetric one, the ranks' blocks
    go through K1 (a ring rank's hop 0 and a column-1 grid's diagonal cells
    through the symmetric pass), so the orders differ.
  - reference replay: none; stdout byte-equal to the reference binary's,
    but for the one pinned line of REPLAY_KNOWN_MISS, which must differ
    exactly as recorded or not at all; through ``--pallas --trig``, none
    and no pinned line.
  - the parity pass against the dense trig path and its plain version on
    the card: none, bit for bit (the same arguments through the CUDA math
    library's atan2, cos and sin, every other operation rounded once, each
    body's terms added in ascending partner order).
  - drift: the fp32 force operator within the gate's TOL_FORCE (2e-3,
    relative with a floor of 1) of float64, bf16's within 1e-2 (its
    inputs are rounded to 8 bits; the TPU record has 3.9e-3), and the
    energy within 5% of E0 at each point (as the bounded-energy test).
  - animate: none; the card's frames are byte-equal to the CPU's render of
    the same recorded positions (as for the frames above).
  - entry: bit-equal to engine.step (the same call).
  - the huge-N path: bit-equal and byte-equal throughout; each K2 row sums
    its columns band by band in an order that does not depend on the rows
    beside it in the launch, and a chunk that starts at a multiple of 128
    keeps the bias segments.  The 8 rows at N=26M against the plain
    version: TOL (2e-6 * max|F|).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import glob
import io
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

KICK = 38.5 / 9.0  # G * 5 * 7 / (1.5 + 1.5)^2
TOL = {torch.float32: 2e-6, torch.float64: 1e-12}  # K1, K2 (the docstring)
TOL_PROBE = 2e-5  # fp32 probe variants up to N=4096 (see the docstring)
MAIN_N, MAIN_STEPS = 65536, 100  # K1's path
# The symmetric pass (K1's square fp32 case): sizes held to its plain
# version, and the top of K1's range, timed beside MAIN_N.
SYM_NS = (384, 4097, MAIN_N, 131072)
SYM_BIG_N = 131072
BIG_N, BIG_STEPS = 262144, 20  # K2's path: above cuda_step.STREAMED_ABOVE
BIG_RUNS = (("fp32", []), ("fp32 compensated", ["--accum=compensated"]),
            ("bf16", ["--dtype=bfloat16"]))
K1, K2 = "block_forces", "block_forces_streamed"
# The frame path: RTIME of several seconds (a step takes ~3.2 ms), so that
# the cadence check asks for more than the one frame an unfenced loop draws.
FRAME_STEPS, FRAME_SECSUP = 2000, 1
RENDER_STEPS = 3  # K1 steps before the frame that is compared with the CPU's
# What a frame may allocate beyond the budget of its hit temporaries: the
# (768, 1024) index map, the selected bodies and the tint's int64 planes.
RENDER_SLACK_BYTES = 32 * 2**20
CKPT_STEPS, CKPT_TOTAL, CKPT_PAST = 60, 100, 40
DIAG_N, DIAG_STEPS = 4096, 20
PROBE_N, PROBE_STEPS = 65536, 20  # both probe drivers' defaults
PROBE_TILE = 1024  # P2's default tile_i and tile_j, used for the timings
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
# The distributed programs.  Phase A: world size 1 on NCCL at K1's width;
# fp64 trig printout at TRIG_N.  Phase B: the ranks emulated on the card,
# from random_state (seed EMU_SEED) with the two bodies on either side of
# the middle made coincident: the pair straddles the boundary of ranks
# 0 | 1 of 2 and 1 | 2 of 4.  Phase C: the CLI's spawned gloo ranks on the
# CPU, byte-equal to one rank, each run killed at CPU_RANKS_TIMEOUT.
DIST_N, DIST_STEPS = MAIN_N, MAIN_STEPS
TRIG_N, TRIG_STEPS = 1024, 10
EMU_SEED = 1
EMU_LAYOUTS = (("allgather", 2), ("allgather", 4), ("ring", 2), ("ring", 4),
               ("grid2d", 2, 2), ("grid2d", 1, 4), ("grid2d", 4, 1))
CPU_RANKS_N, CPU_RANKS_STEPS, CKPT_STEPS_CPU = 97, 100, 60
CPU_RANKS_FLAGS = (["--devices=4"], ["--devices=4", "--comm=ring"],
                   ["--mesh2d=2x2"])
CPU_RANKS_TIMEOUT = 300


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
    """Builds the force kernels, the probes and the parity pass side by
    side (three libraries, every source's nvcc started at once)."""
    from parallel_nbody_tpu_torch.ops import _build
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        libs = {name: pool.submit(_build.load, *args) for name, args in
                (("kernels", ()), ("probes", ("probes",)),
                 ("trig", ("trig",)))}
        libs = {name: f.result() for name, f in libs.items()}
    seconds = time.perf_counter() - t0
    for name, lib in libs.items():
        print("build %s: nvcc %.3f s: %s" % (name, lib.build_seconds,
                                            lib.path))
        if lib.build_log:
            print(lib.build_log.strip())
    print("build: %.3f s to load all three" % seconds)
    _probe_layout(libs["probes"])
    return seconds


def _probe_layout(lib):
    """Prints the probes' row-loop layout: rows per thread, as built (ptxas
    compiled the row kernels with R = ``_probe.ROWS`` as their last template
    argument, or this raises), the column split and its fold
    (``_probe.SPLIT``, which a CPU test holds to csrc/probe_layout.cuh),
    and each probe kernel's registers and spill stores from ptxas."""
    from parallel_nbody_tpu_torch.benchmarks import _probe, sass_census
    from parallel_nbody_tpu_torch.benchmarks import bias_variants_probe as p2
    from parallel_nbody_tpu_torch.benchmarks import roofline_probe as p1
    regs = sass_census.ptxas_registers(lib.build_log)
    if not regs:
        print("probe kernels: no ptxas report (library loaded as built)")
    else:
        missing = [k for k in (sass_census.probe_kernel_name(m.NAME, v)
                               for m in (p1, p2) for v in m.VARIANTS)
                   if k not in regs]
        if missing:
            raise AssertionError("ptxas compiled no %s: the probes library "
                                 "was not built with R=%d" % (missing,
                                                             _probe.ROWS))
    print("probe layout: R=%d rows per thread%s, S=%d column parts, fold %s"
          % (_probe.ROWS, " (as built)" if regs else "", _probe.SPLIT,
             "in a thread block cluster of %d" % _probe.SPLIT
             if _probe.SPLIT > 1 else "none"))
    for name, (count, spill) in sorted(regs.items()):
        print("probe kernel %-34s %3d registers, %d bytes spill stores"
              % (name, count, spill))


def _kernel(kernel):
    """The launcher of K1 or K2: K1 is ``block_forces_one_sided``, which
    launches it on square fp32 blocks too (``block_forces`` hands those to
    the symmetric pass, held in phase_symmetric)."""
    from parallel_nbody_tpu_torch.ops import cuda_step
    return getattr(cuda_step, "block_forces_one_sided" if kernel == K1
                   else kernel)


def _compare(label, rows, cols, dtype, biased, row_g0=0, col_g0=0,
             kernel=K1, tol=None, **kw):
    """Kernel vs plain version on the card; returns (max |error|, ms of the
    plain version's call).  ``kw`` goes to both (band, accum)."""
    from parallel_nbody_tpu_torch.ops import cuda_step
    cfg = _cfg(_name(dtype))
    call = dict(row_g0=row_g0, col_g0=col_g0, biased=biased, **kw)
    got = _kernel(kernel)(cfg, *rows, *cols, **call)
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
    pair = [torch.tensor(v, dtype=dtype, device=dev)
            for v in ([100.0, 100.0], [200.0, 200.0], [5.0, 7.0],
                      [1.5, 1.5])]
    xf, yf = _kernel(kernel)(_cfg(_name(dtype)), *pair, *pair, biased=True,
                             **kw)
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
                    kernel=K2)


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


def _cli(argv, platform, want_rc=0):
    from parallel_nbody_tpu_torch import cli
    os.environ["NBODY_PLATFORM"] = platform
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["nbody"] + argv)
    if rc != want_rc:
        raise AssertionError("cli %s on %s exited %d, expected %d:\n%s"
                             % (argv, platform, rc, want_rc, err.getvalue()))
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


class _Passes(int):
    """block_forces's force passes since its counts were zeroed (an int,
    which the phases hold to their steps), with ``symmetric``, those that
    took the symmetric pass, and ``k1``, those that launched K1."""

    def __new__(cls, passes, symmetric):
        self = super().__new__(cls, passes)
        self.symmetric = symmetric
        self.k1 = passes - symmetric
        return self


def _zero_passes():
    from parallel_nbody_tpu_torch.ops import cuda_step
    cuda_step.block_forces.launches = 0
    cuda_step.block_forces.symmetric_launches = 0


def _passes():
    from parallel_nbody_tpu_torch.ops import cuda_step
    return _Passes(cuda_step.block_forces.launches,
                   cuda_step.block_forces.symmetric_launches)


def _xps_run(n, steps, extra, arena):
    """One ``--run-xps`` CLI run on the card with both kernels' counts set
    to 0 just before it; returns (block_forces's passes, K2 launches,
    RTIME)."""
    from parallel_nbody_tpu_torch.ops import cuda_step
    from parallel_nbody_tpu_torch.utils.output import pair_interactions
    argv = [str(n), "0", arena, str(steps), "--no-clamp", "--pallas",
            "--run-xps"] + extra
    _zero_passes()
    cuda_step.block_forces_streamed.launches = 0
    out, err = _cli(argv, "cuda")
    k1 = _passes()
    k2 = cuda_step.block_forces_streamed.launches
    row = re.fullmatch(r"%d,(\d+\.\d{3}), (\d+\.\d{2})\n" % n, out)
    if row is None:
        raise AssertionError("malformed CSV row: %r" % out)
    rtime = float(row.group(1))
    print("main path: %s" % " ".join(argv))
    print("main path: launches K1 %d symmetric %d K2 %d, RTIME %.3f s, "
          "%.6e unordered pairs/s, GFLOPS (reference model) %s"
          % (k1.k1, k1.symmetric, k2, rtime, pair_interactions(n, steps) / rtime,
             row.group(2)))
    sys.stderr.write(err)
    return k1, k2, rtime


def phase_main_path(arena):
    k1, k2, rtime = _xps_run(MAIN_N, MAIN_STEPS, [], arena)
    if k1 < MAIN_STEPS or k2 != 0 or k1.k1 != 0:
        raise AssertionError("N=%d path launched K1 %d, the symmetric pass "
                             "%d and K2 %d times"
                             % (MAIN_N, k1.k1, k1.symmetric, k2))

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


def phase_sabotage(dev):
    """The comparison must be able to fail: K1 against a plain version with
    gravity's sign flipped trips ``_compare``, or this phase raises."""
    from parallel_nbody_tpu_torch.ops import cuda_step
    from parallel_nbody_tpu_torch.state import init_state
    b = _bodies(init_state(4096, _cfg("float32"), device=dev))
    plain = cuda_step.block_forces_reference

    def flipped(cfg, *args, **kw):
        return plain(cfg.replace(gravity=-cfg.gravity), *args, **kw)

    with mock.patch.object(cuda_step, "block_forces_reference", flipped):
        try:
            _compare("SABOTAGE gravity sign flipped", b, b, torch.float32,
                     False)
        except AssertionError as e:
            print("sabotage: tripped as it must (%s)" % e)
            return
    raise AssertionError("sabotage: K1 agreed with a plain version whose "
                         "gravity has the wrong sign; the comparison "
                         "cannot fail")


def phase_symmetric(dev):
    """The symmetric pass (csrc/forces_symmetric.cu, K1's square fp32 case)
    against its plain version at SYM_NS from the glibc init, both flags,
    each a symmetric launch and bit-equal to a second pass; the kick of
    each KICK_PLACEMENTS pair, bit-equal to the one-sided kernel's
    (``block_forces_one_sided``); far padding exactly 0.  Returns
    (max |error| / max|F| at MAIN_N, the plain version's ms there and at
    SYM_BIG_N)."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from torch_cases import KICK_PLACEMENTS, kick_case
    from parallel_nbody_tpu_torch.ops import cuda_step
    from parallel_nbody_tpu_torch.state import init_state, pad_state
    cfg = _cfg("float32")
    worst, plain_ms = {}, {}
    for n in SYM_NS:
        b = _bodies(init_state(n, cfg, device=dev))
        for biased in (True, False):
            flag = torch.tensor(biased, device=dev)
            before = cuda_step.block_forces.symmetric_launches
            got = cuda_step.block_forces(cfg, *b, *b, biased=flag)
            again = cuda_step.block_forces(cfg, *b, *b, biased=flag)
            torch.cuda.synchronize()
            if cuda_step.block_forces.symmetric_launches != before + 2:
                raise AssertionError("symmetric N=%d: not the symmetric "
                                     "pass" % n)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = cuda_step.block_forces_symmetric_reference(cfg, *b,
                                                              biased=flag)
            end.record()
            torch.cuda.synchronize()
            plain_ms[n] = start.elapsed_time(end)
            scale = max(float(w.abs().max()) for w in want)
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            equal = all(torch.equal(g, a) for g, a in zip(got, again))
            print("symmetric N=%d biased=%-5s vs its plain version max|err| "
                  "%.6e /max|F| %.6e; two passes bit-equal %s; plain %.3f ms"
                  % (n, biased, err, err / scale, equal, plain_ms[n]))
            if not (err <= TOL[torch.float32] * scale and equal):
                raise AssertionError("symmetric N=%d biased=%s: max|err| "
                                     "%.6e of %.6e, bit-equal %s"
                                     % (n, biased, err, scale, equal))
            worst[n] = max(worst.get(n, 0.0), err / scale)
    for name in sorted(KICK_PLACEMENTS):
        rows, _, r0, _, (ia, ib) = kick_case(name)
        b = [torch.tensor(a, dtype=torch.float32, device=dev) for a in rows]
        got = cuda_step.block_forces(cfg, *b, *b, row_g0=r0, col_g0=r0,
                                     biased=True)
        want = cuda_step.block_forces_one_sided(cfg, *b, *b, row_g0=r0,
                                                col_g0=r0, biased=True)
        xf = got[0].cpu()
        if not (all(torch.equal(g, w) for g, w in zip(got, want))
                and float(xf[ia]) > 0 > float(xf[ib])):
            raise AssertionError("symmetric kick %s: %r, %r" % (
                name, float(xf[ia]), float(xf[ib])))
        print("symmetric kick %s: %.9g, %.9g, bit-equal to K1"
              % (name, float(xf[ia]), float(xf[ib])))
    padded, _ = pad_state(init_state(1000, cfg, device=dev), 1152)
    b = _bodies(padded)
    xf, yf = cuda_step.block_forces(cfg, *b, *b, biased=True)
    if bool(xf[1000:].any()) or bool(yf[1000:].any()):
        raise AssertionError("symmetric: far padding feels a force")
    print("symmetric far padding: exactly 0")
    return worst[MAIN_N], plain_ms[MAIN_N], plain_ms[SYM_BIG_N]


def _pixel_report(bodies, j, i):
    """Why pixel (row j, column i) differs between the devices: every body
    whose hit test differs there, with both distances and the threshold."""
    lines = []
    per_device = []
    for tensors in (bodies, tuple(t.cpu() for t in bodies)):
        x, y, r = tensors
        dx, dy = x - float(i), y - float(j)
        d = (dx * dx + dy * dy).sqrt()
        per_device.append((d.cpu(), (d <= r + 0.5).cpu(), (r + 0.5).cpu()))
    (d_card, hit_card, thr), (d_cpu, hit_cpu, _) = per_device
    for b in torch.nonzero(hit_card != hit_cpu)[:, 0].tolist():
        lines.append("body %d at pixel (row %d, column %d): distance on the "
                     "card %r, on the CPU %r, threshold %r"
                     % (b, j, i, float(d_card[b]), float(d_cpu[b]),
                        float(thr[b])))
    return "; ".join(lines) or "no body's hit test differs at (%d, %d)" % (j, i)


def phase_render(dev):
    """The rasterizer at full width: the glibc state at N=65536 after
    RENDER_STEPS K1 steps (fp32) on the 1024x768 arena, rendered on the card
    and, from the same tensors copied to the host, on the CPU: frames
    byte-equal (see the docstring's tolerances; nothing is loosened).  A
    second chunking of rows and bodies on the card gives the same bytes.
    The frame's peak memory above what was allocated before it stays within
    the budget of the hit temporaries plus RENDER_SLACK_BYTES.  Returns (ms
    per frame by CUDA events, peak bytes)."""
    from parallel_nbody_tpu_torch.models.engine import run
    from parallel_nbody_tpu_torch.ops import render
    from parallel_nbody_tpu_torch.state import init_state
    cfg = _cfg("float32")
    st = run(cfg, init_state(MAIN_N, cfg, device=dev), RENDER_STEPS)
    bodies = (st.x, st.y, st.radius)
    ms = _time_ms(lambda: render.render_frame(cfg, *bodies, MAIN_N), 3,
                  warmup=1)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    card = render.render_frame(cfg, *bodies, MAIN_N)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    lit = int(card.any(dim=-1).sum())
    print("render N=%d %dx%d on the card: %.6f ms per frame, peak %d bytes "
          "above the %d allocated before (budget %d + %d), %d of %d pixels lit"
          % (MAIN_N, cfg.xdim, cfg.ydim, ms, peak, before,
             render.HIT_BUDGET_BYTES, RENDER_SLACK_BYTES, lit,
             cfg.xdim * cfg.ydim))
    if lit == 0:
        raise AssertionError("render: the frame is all black")
    if peak > render.HIT_BUDGET_BYTES + RENDER_SLACK_BYTES:
        raise AssertionError("render: peak memory %d bytes is over the "
                             "budget" % peak)
    other = render.render_frame(cfg, *bodies, MAIN_N, 24, 1000)
    if not torch.equal(other, card):
        raise AssertionError("render: row_block=24, body_chunk=1000 gives "
                             "another frame than the default chunking")
    t0 = time.perf_counter()
    host = render.render_frame(cfg, *(t.cpu() for t in bodies), MAIN_N)
    cpu_s = time.perf_counter() - t0
    differ = torch.nonzero((card.cpu() != host).any(dim=-1))
    print("render N=%d on the CPU from the same tensors: %.3f s; %d pixels "
          "differ from the card's frame; second chunking byte-equal"
          % (MAIN_N, cpu_s, differ.shape[0]))
    if differ.shape[0]:
        j, i = differ[0].tolist()
        raise AssertionError("render: card and CPU frames differ in %d "
                             "pixels; %s" % (differ.shape[0],
                                             _pixel_report(bodies, j, i)))
    return ms, peak


def _rtime(err):
    return float(re.search(r"N-body took: (\d+\.\d+) seconds", err).group(1))


def _k1_run(argv, env=None):
    """One CLI run on the card with both kernels' counts set to 0 just
    before it; returns (stdout, stderr, block_forces's passes).  K2 must
    not run."""
    from parallel_nbody_tpu_torch.ops import cuda_step
    _zero_passes()
    cuda_step.block_forces_streamed.launches = 0
    with mock.patch.dict(os.environ, env or {}):
        out, err = _cli(argv, "cuda")
    if cuda_step.block_forces_streamed.launches:
        raise AssertionError("%s launched K2" % " ".join(argv))
    return out, err, _passes()


def phase_frame_path(tmp, render_ms):
    """The frame path at full width: the CLI at N=65536 with
    ``secs_per_update=1`` for FRAME_STEPS steps through K1.  It must draw at
    least int(RTIME / 2) - 1 frames and at least one (without the fence
    before the elapsed check the loop queues every chunk in milliseconds
    and draws one), leave pixels that are not all black, launch K1 once per
    step plus the warm-up step and the cadence probe's step (both on
    discarded copies of the state, outside RTIME), and print the state of
    the same argv with ``secs_per_update=0`` byte for byte (that run
    launches K1 once per step plus the warm-up).  Returns (K1 launches with
    frames, frames, RTIME with frames, RTIME without)."""
    from parallel_nbody_tpu_torch.utils import ppm
    arena = os.path.join(tmp, "frames.ppm")
    handle = ppm.create(arena, 1024, 768)
    log = os.path.join(tmp, "frames.log")
    argv = [str(MAIN_N), str(FRAME_SECSUP), arena, str(FRAME_STEPS),
            "--no-clamp", "--pallas"]
    out, err, k1 = _k1_run(argv, {"NBODY_FRAME_LOG": log})
    rtime = _rtime(err)
    with open(log) as f:
        lines = f.read().splitlines()
    for line in lines:
        if not re.fullmatch(r"frame \d+\.\d{3} nonzero=\d+ tints=\d+ "
                            r"md5=[0-9a-f]{32}", line):
            raise AssertionError("frame log: malformed line %r" % line)
    frames = len(lines)
    need = max(1, int(rtime / (2 * FRAME_SECSUP)) - 1)
    lit = int(ppm.read_pixels(handle).any(axis=-1).sum())
    argv0 = list(argv)
    argv0[1] = "0"
    out0, err0, k1_plain = _k1_run(argv0)
    rtime0 = _rtime(err0)
    print("frame path: %s" % " ".join(argv))
    print("frame path: %d frames in RTIME %.3f s (needs %d); RTIME without "
          "frames %.3f s; frame work (RTIME difference) %.1f%% of RTIME, "
          "%d frames x %.3f ms of render_frame %.1f%%; force passes %d with "
          "frames (symmetric %d), %d without; last frame: %s; %d pixels "
          "lit in the PPM"
          % (frames, rtime, need, rtime0, 100 * (rtime - rtime0) / rtime,
             frames, render_ms, 100 * frames * render_ms / 1e3 / rtime, k1,
             k1.symmetric, k1_plain, lines[-1] if lines else "none", lit))
    if frames < need:
        raise AssertionError("frame path: %d frames in %.3f s, needs %d"
                             % (frames, rtime, need))
    if lit == 0:
        raise AssertionError("frame path: the PPM's pixels are all black")
    if k1 != FRAME_STEPS + 2 or k1_plain != FRAME_STEPS + 1:
        raise AssertionError("frame path: K1 launched %d times with frames "
                             "(expected %d steps + warm-up + probe) and %d "
                             "without (expected steps + warm-up)"
                             % (k1, FRAME_STEPS, k1_plain))
    _state_table(out, MAIN_N)
    if out != out0:
        raise AssertionError("frame path: frames moved the state")
    _frame_host_costs(handle, log)
    return k1, frames, rtime, rtime0


def _frame_host_costs(handle, log):
    """What one frame costs beside render_frame, by the host clock: the
    copy of the (768, 1024, 3) frame to the host, ``write_pixels`` into the
    PPM and the frame log's line."""
    from parallel_nbody_tpu_torch import cli
    from parallel_nbody_tpu_torch.utils import ppm
    frame = ppm.read_pixels(handle)
    on_card = torch.from_numpy(frame.copy()).cuda()
    torch.cuda.synchronize()
    costs = {}
    for name, fn in (("copy to the host", lambda: on_card.cpu().numpy()),
                     ("write_pixels", lambda: ppm.write_pixels(handle, frame)),
                     ("frame log line", lambda: cli._log_frame(log, frame))):
        t0 = time.perf_counter()
        fn()
        costs[name] = (time.perf_counter() - t0) * 1e3
    print("frame path: per frame beside render_frame: %s"
          % ", ".join("%s %.3f ms" % kv for kv in costs.items()))


def phase_checkpoint(tmp, arena, dev):
    """Checkpoint and resume on the card at N=65536 through K1: CKPT_STEPS
    steps with ``--checkpoint``, then ``--resume`` to CKPT_TOTAL: stdout
    byte-equal to the uninterrupted run.  A resume past the target
    (steps=CKPT_PAST) runs no step, launches no kernel, reports 0.00 GFLOPS
    and its ``--checkpoint`` records step CKPT_STEPS and the same state.
    Also times ``save_state`` and ``load_state`` of that state (host clock,
    device synchronized).  Returns (K1 launches of the resumed run, save ms,
    load ms)."""
    from parallel_nbody_tpu_torch.utils import checkpoint as ckpt
    base = [str(MAIN_N), "0", arena]
    flags = ["--no-clamp", "--pallas"]
    a, b = os.path.join(tmp, "a.npz"), os.path.join(tmp, "b.npz")
    full, _, _ = _k1_run(base + [str(CKPT_TOTAL)] + flags)
    first, _, _ = _k1_run(base + [str(CKPT_STEPS)] + flags
                          + ["--checkpoint=" + a])
    resumed, _, k1 = _k1_run(base + [str(CKPT_TOTAL)] + flags
                             + ["--resume=" + a])
    _state_table(resumed, MAIN_N)
    if resumed != full or first == full:
        raise AssertionError("checkpoint: the resumed run's stdout differs "
                             "from the uninterrupted run's")
    if k1 != CKPT_TOTAL - CKPT_STEPS + 1:
        raise AssertionError("checkpoint: the resumed run launched K1 %d "
                             "times, expected %d steps + warm-up"
                             % (k1, CKPT_TOTAL - CKPT_STEPS))
    past, _, k1_past = _k1_run(base + [str(CKPT_PAST)] + flags + [
        "--resume=" + a, "--checkpoint=" + b, "--run-xps"])
    if k1_past or not re.fullmatch(r"%d,\d+\.\d{3}, 0\.00\n" % MAIN_N, past):
        raise AssertionError("checkpoint: resume past the target launched "
                             "K1 %d times and printed %r" % (k1_past, past))
    with np.load(a) as za, np.load(b) as zb:
        if int(za["step"]) != CKPT_STEPS or int(zb["step"]) != CKPT_STEPS:
            raise AssertionError("checkpoint: steps %d and %d recorded, "
                                 "expected %d" % (za["step"], zb["step"],
                                                  CKPT_STEPS))
        for name in za.files:
            if za[name].tobytes() != zb[name].tobytes():
                raise AssertionError("checkpoint: %s changed in a run of "
                                     "no steps" % name)
    t0 = time.perf_counter()
    state, step = ckpt.load_state(a, dev, torch.float32)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ckpt.save_state(os.path.join(tmp, "c.npz"), state, step)
    save_ms = (time.perf_counter() - t0) * 1e3
    print("checkpoint N=%d: %d + %d steps byte-equal to %d uninterrupted; "
          "resume past the target ran no step and recorded step %d; "
          "save_state %.3f ms, load_state %.3f ms (%d bytes)"
          % (MAIN_N, CKPT_STEPS, CKPT_TOTAL - CKPT_STEPS, CKPT_TOTAL,
             CKPT_STEPS, save_ms, load_ms, os.path.getsize(a)))
    return k1, save_ms, load_ms


def phase_diagnostics(tmp, arena):
    """``--check-nans`` and ``--trace`` at N=DIAG_N on the card in fp32:
    the validation line of a clean run, whose stdout is the unchecked run's;
    a checkpoint with a NaN planted in ``xv`` exits 1 naming the field when
    no step is left to run, and raises FloatingPointError naming the field
    and the step when one is; the trace directory holds one trace with
    device kernels of non-zero time, the force pass's among them (fp32: the
    symmetric kernel), and the ``Trace:``
    line reports a 0.00% collective share."""
    import gzip
    base = [str(DIAG_N), "0", arena]
    flags = ["--pallas"]
    plain, _ = _cli(base + [str(DIAG_STEPS)] + flags, "cuda")
    checked, err = _cli(base + [str(DIAG_STEPS)] + flags + ["--check-nans"],
                        "cuda")
    line = [l for l in err.splitlines() if l.startswith("State validation")]
    if checked != plain or len(line) != 1 or not re.fullmatch(
            r"State validation ok: max\|v\|=\S+ max\|f\|=\S+ "
            r"in_bounds=True", line[0]):
        raise AssertionError("--check-nans: %r" % (line,))
    print("--check-nans N=%d: %s" % (DIAG_N, line[0]))

    ck = os.path.join(tmp, "clean.npz")
    bad = os.path.join(tmp, "poisoned.npz")
    _cli(base + ["5"] + flags + ["--checkpoint=" + ck], "cuda")
    with np.load(ck) as z:
        fields = {k: z[k].copy() for k in z.files}
    fields["xv"][7] = np.nan
    np.savez(bad, **fields)
    out, err = _cli(base + ["5"] + flags + ["--resume=" + bad,
                                            "--check-nans"], "cuda", want_rc=1)
    if out or "State validation FAILED: NaNs in xv\n" not in err:
        raise AssertionError("--check-nans: a planted NaN gave %r" % err)
    try:
        _cli(base + ["9"] + flags + ["--resume=" + bad, "--check-nans"],
             "cuda")
    except FloatingPointError as e:
        if not re.search(r"\bxv\b.* after step 6$", str(e)):
            raise AssertionError("--check-nans: raised %r" % str(e))
        print("--check-nans: planted NaN exits 1 naming xv; mid-run: %s" % e)
    else:
        raise AssertionError("--check-nans: a planted NaN ran to the end")

    trace_dir = os.path.join(tmp, "trace")
    traced, err = _cli(base + [str(DIAG_STEPS)] + flags
                       + ["--trace=" + trace_dir], "cuda")
    line = [l for l in err.splitlines() if l.startswith("Trace:")]
    files = glob.glob(os.path.join(trace_dir, "*.trace.json.gz"))
    if traced != plain or len(files) != 1 or len(line) != 1 or not \
            line[0].endswith("(0.00%% share) -> %s" % trace_dir):
        raise AssertionError("--trace: %d traces, stderr %r" % (len(files),
                                                                err))
    with gzip.open(files[0], "rt") as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    device_us = sum(e["dur"] for e in kernels)
    # The fp32 pass of one block against itself: the symmetric kernel.
    k1_us = sum(e["dur"] for e in kernels
                if "block_forces_symmetric_kernel" in e["name"])
    print("--trace N=%d x %d steps: %s; %d device kernel events, %.3f ms, "
          "the symmetric force kernel %.3f ms of it"
          % (DIAG_N, DIAG_STEPS, line[0], len(kernels), device_us / 1e3,
             k1_us / 1e3))
    if not device_us > 0 or not k1_us > 0:
        raise AssertionError("--trace: the trace holds no device time")


# phase_reference_replay: the reference binary's committed outputs.  The JAX
# repo's fuzz sweeps cached every output they diffed against as
# tests_out/fuzz*/seq_<N>_<STEPS>.out (203 distinct (N, steps), N 2-254);
# the golden fixtures of at most 1000 steps (REF_OUTPUT's 100000 steps are
# left out: ~50 s of a host-bound step on their own); and the 45 two-leg
# resume records of tests_out/fuzz_resume*, each leg diffed against the
# uninterrupted output at its own step count.
REPLAY_ORACLES = 203
REPLAY_RESUMES = 45
REPLAY_FIXTURES = (("seq_2_1000.out", 2, 1000), ("seq_64_500.out", 64, 500),
                   ("seq_256_300.out", 256, 300),
                   ("seq_1000_100.out", 1000, 100),
                   ("seq_2048_100.out", 2048, 100),
                   ("seq_4096_100.out", 4096, 100),
                   ("seq_10000_100.out", 10000, 100),
                   ("128_MY_REF_OUTPUT", 128, 1000))
REPLAY_FLAGS = ["--pallas", "--dtype=float64"]
TRIG_REPLAY_FLAGS = ["--pallas", "--trig"]
# The parity pass: sizes held to the dense path and the plain version, and
# the sizes timed (CUDA events).
TRIG_NS = (2, 1000, 4096, 10000)
TRIG_SMALL_N = 10000
# Steps of the parity mode's main path at MAIN_N (phase_main_path_trig).
TRIG_MAIN_STEPS = 3
# Published FP64 peak of one H100 SXM at 700 W, outside the tensor cores.
PEAK_FP64_FLOPS = 34e12
# The one run where K1's fast formula misses the reference's bytes: body
# 8344's y-force at step 100, whose exact value lies 4 ulps under the
# rounding boundary of its third decimal (bin/torch/boundary_digits.py).
# The fast formula rounds it down in the TPU kernel's tile order, as K1 and
# its plain version sum (the Pallas kernel too), and its column-order sum
# misses another line; the reference's trig arithmetic rounds it up.  It is
# an open question (PERF.md), pinned here: that run must print exactly this
# line against exactly that one, or the oracle's bytes.
REPLAY_KNOWN_MISS = {
    "tests/fixtures/seq_10000_100.out": (
        8345,
        "   597.001    171.002 6725900.304 29213247.339      2.922      3.538",
        "   597.001    171.002 6725900.304 29213247.340      2.922      3.538"),
}


def _replay_sets(root):
    """The committed oracles {(n, steps): path} and the resume records
    [(n, split, total, leg-1 oracle, leg-2 oracle)] under root/tests_out."""
    oracles, resumes = {}, []
    for d in sorted(glob.glob(os.path.join(root, "tests_out", "fuzz*"))):
        for f in sorted(os.listdir(d)):
            m = re.fullmatch(r"seq_(\d+)_(\d+)\.out", f)
            if m:
                oracles.setdefault((int(m[1]), int(m[2])),
                                   os.path.join(d, f))
            m = re.fullmatch(r"resume_(\d+)_(\d+)of(\d+)_.*\.out", f)
            if m and not f.endswith(".leg1.out"):
                n, split, total = map(int, m.groups())
                resumes.append((n, split, total) + tuple(
                    os.path.join(d, "seq_%d_%d.out" % (n, k))
                    for k in (split, total)))
    return oracles, resumes


def phase_reference_replay(dev, tmp, trig=False):
    """K1 in fp64 against the reference binary's own bytes: every committed
    oracle and fixture of _replay_sets / REPLAY_FIXTURES through the CLI
    in-process, ``N 0 arena STEPS --pallas --dtype=float64`` on the card
    (K1's fp64 instantiation; the coincidence flag read on the device),
    stdout byte-equal to the oracle but for REPLAY_KNOWN_MISS; then every
    resume record single-rank on the card, a .npz checkpoint at the split
    and a resume to the total, both legs byte-equal.  K1 launches once for
    the warm-up step and once a step of each run.  With ``trig`` the runs
    are ``--pallas --trig`` (the parity pass, which launches instead of K1)
    and no line is pinned.  Returns (the kernel's launches, runs, seconds,
    the known misses that showed)."""
    from parallel_nbody_tpu_torch.ops import cuda_step
    from parallel_nbody_tpu_torch.utils import ppm
    flags, known_miss = ((TRIG_REPLAY_FLAGS, {}) if trig
                         else (REPLAY_FLAGS, REPLAY_KNOWN_MISS))
    label = "reference replay" + (" --trig" if trig else "")
    root = os.path.dirname(os.path.abspath(__file__))
    oracles, resumes = _replay_sets(root)
    if len(oracles) != REPLAY_ORACLES or len(resumes) != REPLAY_RESUMES:
        raise AssertionError("reference replay: %d oracles and %d resume "
                             "records, expected %d and %d"
                             % (len(oracles), len(resumes), REPLAY_ORACLES,
                                REPLAY_RESUMES))
    plain = [(n, steps, path) for (n, steps), path in sorted(oracles.items())]
    plain += [(n, steps, os.path.join(root, "tests", "fixtures", name))
              for name, n, steps in REPLAY_FIXTURES]
    arena = os.path.join(tmp, "replay.ppm")
    ppm.create(arena, 1024, 768)
    ck = os.path.join(tmp, "replay.npz")
    mismatches, known, runs, launches = [], [], 0, 0

    def run(n, steps, path, extra=()):
        nonlocal runs
        out, _ = _cli([str(n), "0", arena, str(steps)] + flags
                      + list(extra), "cuda")
        runs += 1
        with open(path) as f:
            want = f.read()
        if out != want:
            got_l, want_l = out.splitlines(), want.splitlines()
            diff = [(i + 1, a, b) for i, (a, b) in enumerate(zip(got_l,
                                                                  want_l))
                    if a != b]
            rel = os.path.relpath(path, root)
            if (not extra and len(got_l) == len(want_l)
                    and diff == [known_miss.get(rel)]):
                known.append(rel)
                return
            line = next(i for i, (a, b) in enumerate(zip(
                got_l + [""], want_l + [""])) if a != b)
            mismatches.append("N=%d steps=%d %s(%s) line %d: %r, want %r"
                              % (n, steps, "".join(e + " " for e in extra),
                                 rel, line + 1, got_l[line:line + 1],
                                 want_l[line:line + 1]))

    t0 = _reset_counts()
    cuda_step.trig_forces.launches = 0
    for n, steps, path in plain:
        run(n, steps, path)
        launches += 1 + steps
    for n, split, total, leg1, leg2 in resumes:
        if os.path.exists(ck):
            os.remove(ck)
        run(n, split, leg1, ["--checkpoint=" + ck])
        run(n, total, leg2, ["--resume=" + ck])
        launches += 2 + total
    seconds = time.perf_counter() - t0
    print("%s: %d runs (%d oracles, %d fixtures, %d resumes x 2 legs), %d "
          "mismatches, %d known (pinned) misses, %.1f s"
          % (label, runs, len(oracles), len(REPLAY_FIXTURES), len(resumes),
             len(mismatches), len(known), seconds))
    for rel in known:
        line, got, want = known_miss[rel]
        print("%s KNOWN MISS (open question): %s line %d: %r, want %r"
              % (label, rel, line, got, want))
    for line in mismatches:
        print("%s MISMATCH: %s" % (label, line))
    k1, _ = _read_counts(label, t0, 0 if trig else launches, 0)
    trig_launches = cuda_step.trig_forces.launches
    print("%s: parity pass launches %d" % (label, trig_launches))
    if trig_launches != (launches if trig else 0):
        raise AssertionError("%s: the parity pass launched %d times"
                             % (label, trig_launches))
    if mismatches:
        raise AssertionError("%s: %d of %d runs differ from the reference's "
                             "bytes" % (label, len(mismatches), runs))
    return trig_launches if trig else k1, runs, seconds, known


def phase_trig(dev):
    """The parity pass (csrc/forces_trig.cu) at TRIG_NS, from the glibc
    init and from random_state, against the dense trig path and its plain
    version on the card (bit for bit), two passes bit-equal; at MAIN_N,
    past the dense path's reach, against its plain version on the card;
    then its times at TRIG_SMALL_N and MAIN_N beside the dense path's and
    the plain version's at TRIG_SMALL_N.  Returns ({label: ms}, the
    launches it counted, max |kernel - plain version| at MAIN_N)."""
    from parallel_nbody_tpu_torch.config import SimConfig
    from parallel_nbody_tpu_torch.ops import cuda_step
    from parallel_nbody_tpu_torch.ops.forces import compute_forces_dense
    from parallel_nbody_tpu_torch.state import init_state, random_state
    cfg = SimConfig(force_mode="trig", dtype="float64", kernel="cuda")
    dense = cfg.replace(kernel="dense")

    def bodies(n, law):
        st = (init_state(n, cfg, device=dev) if law == "glibc" else
              random_state(n, cfg, torch.Generator(device=dev).manual_seed(n),
                           device=dev))
        return [st.x, st.y, st.mass, st.radius]

    def same(a, b):
        return all(torch.equal(u.view(torch.int64), v.view(torch.int64))
                   for u, v in zip(a, b))

    cuda_step.trig_forces.launches = 0
    passes = 0
    for n in TRIG_NS:
        for law in ("glibc", "uniform"):
            b = bodies(n, law)
            want = compute_forces_dense(dense, *b)
            plain = cuda_step.trig_forces_reference(cfg, *b)
            got = cuda_step.trig_forces(cfg, *b)
            again = cuda_step.trig_forces(cfg, *b)
            passes += 2
            ok = same(got, want) and same(got, plain) and same(again, got)
            print("parity pass N=%d %s: bit-equal to the dense path, the "
                  "plain version and itself: %s" % (n, law, ok))
            if not ok:
                raise AssertionError("parity pass N=%d %s differs" % (n, law))
            del want, plain
            torch.cuda.empty_cache()
    b = bodies(MAIN_N, "glibc")
    t0 = time.perf_counter()
    plain = cuda_step.trig_forces_reference(cfg, *b)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    got = cuda_step.trig_forces(cfg, *b)
    passes += 1
    max_err = max(float((g - w).abs().max()) for g, w in zip(got, plain))
    print("parity pass N=%d glibc: max|kernel - plain version| %r (plain "
          "version %.2f s), bit-equal: %s"
          % (MAIN_N, max_err, plain_s, same(got, plain)))
    if not same(got, plain):
        raise AssertionError("parity pass N=%d differs from its plain "
                             "version by %r" % (MAIN_N, max_err))
    del got, plain
    if cuda_step.trig_forces.launches != passes:
        raise AssertionError("parity pass: %d launches counted for %d passes"
                             % (cuda_step.trig_forces.launches, passes))
    times = {}
    for n, reps in ((TRIG_SMALL_N, 20), (MAIN_N, 5)):
        b = bodies(n, "glibc")
        times["ms_n%d" % n] = _time_ms(lambda: cuda_step.trig_forces(cfg, *b),
                                       reps)
        if n == TRIG_SMALL_N:
            times["dense_ms_n%d" % n] = _time_ms(
                lambda: compute_forces_dense(dense, *b), 3, warmup=1)
            times["plain_ms_n%d" % n] = _time_ms(
                lambda: cuda_step.trig_forces_reference(cfg, *b), 3,
                warmup=1)
    for key, ms in times.items():
        print("parity pass time %s: %.6f ms" % (key, ms))
    return times, cuda_step.trig_forces.launches, max_err


def phase_main_path_trig(arena):
    """The parity mode's main path at MAIN_N: the CLI's ``N 0 arena
    TRIG_MAIN_STEPS --no-clamp --pallas --trig`` on the card with the
    parity pass's counter zeroed just before it (one launch for the
    warm-up step and one a step; no K1, symmetric pass or K2), its stdout
    byte-equal to the same run with the parity pass's forces from its plain
    version on the card.  Returns the parity pass's launches."""
    from parallel_nbody_tpu_torch.models import engine
    from parallel_nbody_tpu_torch.ops import cuda_step
    argv = [str(MAIN_N), "0", arena, str(TRIG_MAIN_STEPS), "--no-clamp",
            "--pallas", "--trig"]

    def plain_forces(cfg, x, y, mass, radius, **_):
        return cuda_step.trig_forces_reference(cfg, x, y, mass, radius)

    _zero_passes()
    cuda_step.block_forces_streamed.launches = 0
    cuda_step.trig_forces.launches = 0
    t0 = time.perf_counter()
    out, _ = _cli(argv, "cuda")
    seconds = time.perf_counter() - t0
    launches = cuda_step.trig_forces.launches
    k1, k2 = _passes(), cuda_step.block_forces_streamed.launches
    with mock.patch.object(engine, "cuda_forces", plain_forces):
        want, _ = _cli(argv, "cuda")
    _state_table(out, MAIN_N)
    print("main path trig: %s: parity pass launches %d (K1 %d, symmetric "
          "%d, K2 %d), %.1f s; stdout byte-equal to the plain version's: %s"
          % (" ".join(argv), launches, k1.k1, k1.symmetric, k2, seconds,
             out == want))
    if launches != 1 + TRIG_MAIN_STEPS or k1 != 0 or k2 != 0:
        raise AssertionError("N=%d parity path launched the parity pass %d "
                             "times, K1's path %d and K2 %d"
                             % (MAIN_N, launches, k1, k2))
    if out != want:
        raise AssertionError("N=%d parity path: stdout differs from the "
                             "plain version's" % MAIN_N)
    return launches


def _spawn_cpu(args, timeout=CPU_RANKS_TIMEOUT):
    """``python args...`` on this machine's CPU (no card visible, one
    thread per process) in a session of its own, killed with every rank it
    started at the timeout.  Returns (rc, stdout, stderr, seconds)."""
    env = dict(os.environ, NBODY_PLATFORM="cpu", CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable] + args, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError("%s: killed after %d s" % (" ".join(args),
                                                        timeout))
    return proc.returncode, out, err, time.perf_counter() - t0


def _cpu_cli(argv):
    rc, out, err, s = _spawn_cpu(["-m", "parallel_nbody_tpu_torch.cli"]
                                 + argv)
    if rc != 0:
        raise AssertionError("cpu ranks: %s exited %d:\n%s"
                             % (" ".join(argv), rc, err[-3000:]))
    return out, s


def _cpu_ranks_tasks(arena, tmp):
    """Phase C's runs, each a task for a pool: the CLI's spawned gloo
    ranks on this machine's torch (CPU), and the directory checkpoint
    written by two ranks and resumed by one."""
    base = [str(CPU_RANKS_N), "0", arena, str(CPU_RANKS_STEPS)]

    def ranks(flags):
        return lambda: _cpu_cli(base + flags)

    def dryrun():
        rc, out, err, s = _spawn_cpu(
            ["-m", "parallel_nbody_tpu_torch.parallel.dryrun", "4"])
        if rc != 0 or out.splitlines()[-1:] != ["MULTIHOST_OK"]:
            raise AssertionError("dryrun 4 exited %d:\n%s\n%s"
                                 % (rc, out, err[-3000:]))
        return out, s

    def checkpoint_two_ranks():
        return _cpu_cli(base[:3] + [str(CKPT_STEPS_CPU), "--devices=2",
                                    "--checkpoint=" + os.path.join(
                                        tmp, "cpu_ranks_ck")])

    tasks = {"dryrun 4": dryrun, "checkpoint": checkpoint_two_ranks}
    for flags in CPU_RANKS_FLAGS:
        tasks[" ".join(flags)] = ranks(flags)
    return tasks


def phase_cpu_ranks(futures, arena, tmp):
    """Phase C: every spawned-rank run's stdout byte-equal to one rank's
    (fp64 trig, N=CPU_RANKS_N, run here on the CPU), and so is one rank's
    resume of the two ranks' directory checkpoint; dryrun 4 printed
    MULTIHOST_OK; and on the card ``--devices=2`` exits 1 with the mesh
    message (one card: NCCL takes one rank per card)."""
    base = [str(CPU_RANKS_N), "0", arena, str(CPU_RANKS_STEPS)]
    want, _ = _cli(base, "cpu")
    results = {name: f.result() for name, f in futures.items()}
    _, seconds = results.pop("checkpoint")
    results["2 ranks checkpoint at %d, 1 rank resumed" % CKPT_STEPS_CPU] = (
        _cli(base + ["--resume=" + os.path.join(tmp, "cpu_ranks_ck")],
             "cpu")[0], seconds)
    for name, (out, seconds) in results.items():
        if name == "dryrun 4":
            print("cpu ranks: dryrun 4 (%.1f s): %s"
                  % (seconds, " | ".join(out.splitlines())))
            continue
        print("cpu ranks: %s N=%d %d steps (%.1f s): %s"
              % (name, CPU_RANKS_N, CPU_RANKS_STEPS, seconds,
                 "byte-equal to one rank" if out == want else "DIFFERS"))
        if out != want:
            raise AssertionError("cpu ranks %s: the printout differs from "
                                 "the single rank's" % name)
    _, err = _cli(["16", "0", arena, "3", "--devices=2"], "cuda", want_rc=1)
    message = ("requested a 2-device mesh but only %d device(s) are "
               "available (backend=cuda)" % torch.cuda.device_count())
    print("cards: --devices=2 exits 1: %s" % err.strip().splitlines()[-1])
    if message not in err:
        raise AssertionError("--devices=2 on one card: %r" % err)


def _engine_ref(cfg, st, steps):
    """engine.run from ``st`` with the counts set to 0 just before it:
    (state, seconds, block_forces's passes)."""
    from parallel_nbody_tpu_torch.models.engine import run
    _zero_passes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run(cfg, st, steps)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, _passes()


def _world_runners(cfg, steps):
    from parallel_nbody_tpu_torch.parallel.grid2d import (make_grid2d_run,
                                                          make_mesh2d)
    from parallel_nbody_tpu_torch.parallel.mesh import make_mesh
    from parallel_nbody_tpu_torch.parallel.sharded_step import \
        make_sharded_run
    mesh = make_mesh(1, "cuda")
    return {"allgather": make_sharded_run(cfg, mesh, steps, "allgather"),
            "ring": make_sharded_run(cfg, mesh, steps, "ring"),
            "grid2d 1x1": make_grid2d_run(cfg, make_mesh2d(1, 1, "cuda"),
                                          steps)}


def phase_world_of_one(dev, tmp):
    """Phase A: the three distributed programs under an NCCL process group
    of this process alone, at N=DIST_N fp32 through K1 from the CLI's glibc
    init (so the biased kernel runs), DIST_STEPS steps each with the counts
    set to 0 just before: bit-equal to engine.run, K1 launched once a step,
    their unordered pairs/s beside engine.run's (taken before and after);
    then fp64 trig at N=TRIG_N, the printout byte-equal.  Returns
    ({program: K1 launches}, {program: pairs/s}, any_coincident_tagged's ms
    on a ring hop's and a grid step's inputs at world size 1)."""
    import torch.distributed as dist

    from parallel_nbody_tpu_torch.config import SimConfig
    from parallel_nbody_tpu_torch.models.engine import run
    from parallel_nbody_tpu_torch.ops import cuda_step
    from parallel_nbody_tpu_torch.state import init_state
    from parallel_nbody_tpu_torch.utils.output import (format_state,
                                                       pair_interactions)
    store = dist.FileStore(os.path.join(tmp, "nccl_store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        cfg = _cfg("float32")
        st = init_state(DIST_N, cfg, device=dev)
        pairs = pair_interactions(DIST_N, DIST_STEPS)
        runners = _world_runners(cfg, DIST_STEPS)
        for runner in _world_runners(cfg, 1).values():
            runner(st)  # NCCL's communicators and the kernels, untimed
        want, t_engine, k1 = _engine_ref(cfg, st, DIST_STEPS)
        rates = {"engine.run": pairs / t_engine}
        launches = {}
        for name, runner in runners.items():
            _zero_passes()
            cuda_step.block_forces_streamed.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = runner(st)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches[name] = _passes()
            rates[name] = pairs / seconds
            equal = all(torch.equal(g, w) for g, w in zip(got, want))
            print("world of one (nccl) %-10s N=%d x %d steps: %.6f s, "
                  "%.6e unordered pairs/s (engine.run %.6e), force passes "
                  "%d (symmetric %d), K2 %d, bit-equal to engine.run: %s"
                  % (name, DIST_N, DIST_STEPS, seconds, rates[name],
                     rates["engine.run"], launches[name],
                     launches[name].symmetric,
                     cuda_step.block_forces_streamed.launches, equal))
            if not equal or launches[name] != DIST_STEPS or \
                    cuda_step.block_forces_streamed.launches:
                raise AssertionError("world of one %s: bit-equal %s, K1 %d "
                                     "launches" % (name, equal,
                                                   launches[name]))
        _, t_after, _ = _engine_ref(cfg, st, DIST_STEPS)
        print("world of one: engine.run again %.6e unordered pairs/s"
              % (pairs / t_after))
        ids = torch.arange(DIST_N, device=dev)
        two = [torch.cat([t, t]) for t in (st.x, st.y, st.mass)]
        tagged_ms = _time_ms(lambda: cuda_step.any_coincident_tagged(
            *two, torch.cat([ids, ids])), 20)
        print("world of one: any_coincident_tagged on 2 x %d bodies (a "
              "ring hop's or a 1x1 grid step's input) %.6f ms, "
              "any_coincident on %d %.6f ms"
              % (DIST_N, tagged_ms, DIST_N, _time_ms(
                  lambda: cuda_step.any_coincident(st.x, st.y, st.mass),
                  20)))

        trig = SimConfig(force_mode="trig", dtype="float64")
        st64 = init_state(TRIG_N, trig, device=dev)
        want = format_state(run(trig, st64, TRIG_STEPS))
        for name, runner in _world_runners(trig, TRIG_STEPS).items():
            if format_state(runner(st64)) != want:
                raise AssertionError("world of one %s: fp64 trig printout "
                                     "differs from engine.run's" % name)
        print("world of one: fp64 trig N=%d x %d steps, the three programs' "
              "printout byte-equal to engine.run's" % (TRIG_N, TRIG_STEPS))
    finally:
        dist.destroy_process_group()
    return launches, rates, tagged_ms


def _plain_auto(cfg, xi, yi, mi, ri, xj, yj, mj, rj, **kw):
    """``block_forces_auto`` with the kernels' plain versions."""
    from parallel_nbody_tpu_torch.ops import cuda_step
    plain = (cuda_step.block_forces_streamed_reference
             if max(xi.shape[0], xj.shape[0]) > cuda_step.STREAMED_ABOVE
             else cuda_step.block_forces_reference)
    return plain(cfg, xi, yi, mi, ri, xj, yj, mj, rj, **kw)


@contextlib.contextmanager
def _ranks_through(fn):
    """The ranks' force functions call ``fn`` in place of
    ``block_forces_auto``."""
    from parallel_nbody_tpu_torch.parallel import grid2d, sharded_step
    with mock.patch.object(sharded_step, "block_forces_auto", fn), \
            mock.patch.object(grid2d, "block_forces_auto", fn):
        yield


def _emulation_state(n, dev):
    """``random_state`` (seeded; no coincident pair) with bodies n/2 - 1
    and n/2 made coincident, a pair across rank boundaries."""
    from parallel_nbody_tpu_torch.state import random_state
    gen = torch.Generator(device=dev).manual_seed(EMU_SEED)
    st = random_state(n, _cfg("float32"), gen, device=dev)
    x, y = st.x.clone(), st.y.clone()
    x[n // 2], y[n // 2] = x[n // 2 - 1], y[n // 2 - 1]
    return st._replace(x=x, y=y)


def _rank_flags(st, layout):
    """Which tagged coincidence flags are set: per rank of a ring, one per
    hop; per rank of a grid, one per step."""
    from parallel_nbody_tpu_torch.ops.cuda_step import any_coincident_tagged
    from parallel_nbody_tpu_torch.parallel.grid2d import group_ids
    p = layout[1] if layout[0] == "ring" else layout[1] * layout[2]
    shard = st.n // p
    full = (st.x, st.y, st.mass)
    flags = []
    if layout[0] == "ring":
        ids = torch.arange(shard, device=st.x.device)
        for k in range(p):
            for s in range(p):
                v = (k + s) % p
                sl = [slice(k * shard, (k + 1) * shard),
                      slice(v * shard, (v + 1) * shard)]
                flags.append(bool(any_coincident_tagged(
                    *(torch.cat([a[sl[0]], a[sl[1]]]) for a in full),
                    torch.cat([k * shard + ids, v * shard + ids]))))
        return flags
    _, pr, pc = layout
    for r in range(pr):
        for c in range(pc):
            gid_row, gid_col = group_ids(shard, r, c, pr, pc, st.x.device)
            gid = torch.cat([gid_row, gid_col])
            flags.append(bool(any_coincident_tagged(*(a[gid] for a in full),
                                                    gid)))
    return flags


def _flag_ms(st, layout):
    """The coincidence flag's ms in one step of rank 0: ``any_coincident``
    on all N for the all-gather ranks, ``any_coincident_tagged`` on its p
    hops of a ring (own + visiting block each) or on its row + col groups
    on a grid.  Timed alone, this is mostly the rate at which the host
    queues the sorts' launches."""
    from parallel_nbody_tpu_torch.ops.cuda_step import (any_coincident,
                                                        any_coincident_tagged)
    if layout[0] == "allgather":
        return _time_ms(lambda: any_coincident(st.x, st.y, st.mass), 20)
    p = layout[1] if layout[0] == "ring" else layout[1] * layout[2]
    shard = st.n // p
    if layout[0] == "ring":
        n_in, calls = 2 * shard, p
    else:
        n_in, calls = shard * (layout[1] + layout[2]), 1
    args = [t[:n_in] for t in (st.x, st.y, st.mass)]
    ids = torch.arange(n_in, device=st.x.device)
    return calls * _time_ms(lambda: any_coincident_tagged(*args, ids), 20)


def _check_layout(cfg, st, layout, whole, whole_ms, kernel=K1):
    """One layout of phase B: every rank through the kernel (counted)
    against the same rank through the plain version, the assembled forces
    against the single-device pass ``whole``, and each rank's ms by CUDA
    events.  Returns (max |error| of a rank, launches, [rank ms])."""
    from parallel_nbody_tpu_torch.ops import cuda_step
    from parallel_nbody_tpu_torch.parallel import emulate
    from parallel_nbody_tpu_torch.parallel import sharded_step
    progs = emulate.rank_programs(cfg, st, layout)
    counter = getattr(cuda_step, kernel)
    _zero_passes()
    counter.launches = 0
    auto = sharded_step.block_forces_auto  # what the ranks call now
    calls = [[] for _ in progs]  # each rank's kernel calls, to replay
    got = []
    for rank, prog in enumerate(progs):
        def record(cfg, *args, _calls=calls[rank], **kw):
            _calls.append((args, kw))
            return auto(cfg, *args, **kw)
        with _ranks_through(record):
            got.append(prog())
    launches = _passes() if kernel == K1 else counter.launches
    with _ranks_through(_plain_auto):
        want = [prog() for prog in progs]
    torch.cuda.synchronize()
    worst = 0.0
    tol = TOL[torch.float32]
    for rank, (g, w) in enumerate(zip(got, want)):
        scale = max(float(t.abs().max()) for t in w)
        err = max(float((a - b).abs().max()) for a, b in zip(g, w))
        worst = max(worst, err)
        if not err <= tol * scale:
            raise AssertionError("%s rank %d: kernel vs plain max|err| %.6e "
                                 "(max|F| %.6e)" % (layout, rank, err, scale))
    full = emulate.combine(got, layout)
    scale = max(float(t.abs().max()) for t in whole)
    err = max(float((a - b).abs().max()) for a, b in zip(full, whole))
    bit_equal = all(torch.equal(a, b) for a, b in zip(full, whole))
    if not err <= tol * scale:
        raise AssertionError("%s: the ranks together differ from the single-"
                             "device pass by %.6e (max|F| %.6e)"
                             % (layout, err, scale))
    # Each rank's pass: its kernel calls alone, replayed; then its whole
    # force computation (coincidence flag included), whose sorts' many
    # small launches the host queues more slowly than the card runs them.
    ms = [_time_ms(lambda rank_calls=rank_calls: [
        auto(cfg, *a, **kw) for a, kw in rank_calls], 5, warmup=1)
        for rank_calls in calls]
    step_ms = [_time_ms(prog, 5, warmup=1) for prog in progs]
    p = emulate.ranks(layout)
    print("ranks %-13s N=%d through %s: %d launches; each rank vs its plain "
          "version max|err| %.6e; whole vs single-device %.6e /max|F| "
          "%.6e%s; rank passes ms %s (sum %.6f) vs the full pass / %d = "
          "%.6f (%.3fx to %.3fx); with the flag ms %s; the flag alone "
          "%.6f ms a step"
          % ("x".join(map(str, layout[1:])) + " " + layout[0], st.n,
             "K2" if kernel == K2 else "K1", launches, worst, err,
             err / scale, ", bit-equal" if bit_equal else "",
             " ".join("%.6f" % t for t in ms), sum(ms), p, whole_ms / p,
             min(ms) / (whole_ms / p), max(ms) / (whole_ms / p),
             " ".join("%.6f" % t for t in step_ms), _flag_ms(st, layout)))
    return worst, launches, ms


def phase_emulated_ranks(dev):
    """Phase B: the ranks emulated on the one card (``parallel.emulate``).
    For each of EMU_LAYOUTS at N=MAIN_N fp32 (random_state with a pair
    coincident across rank boundaries, so the tagged flag is set on some
    ranks and clear on others): every rank through K1 at its offsets
    against its plain version, the whole against the single-device K1 pass,
    each rank's kernel pass and whole step by CUDA events, and the flag's
    time; then K2 through the
    all-gather path at N=BIG_N over 2 ranks.  Returns ({layout: K1
    launches}, K2 launches, max |error|)."""
    from parallel_nbody_tpu_torch.ops import cuda_step
    cfg = _cfg("float32")
    st = _emulation_state(MAIN_N, dev)
    b = _bodies(st)
    flag = cuda_step.any_coincident(st.x, st.y, st.mass)
    if not bool(flag):
        raise AssertionError("emulation state: the placed pairs are not "
                             "coincident")
    whole = cuda_step.block_forces(cfg, *b, *b, biased=flag)
    whole_ms = _time_ms(lambda: cuda_step.block_forces(cfg, *b, *b,
                                                       biased=flag), 10)
    print("ranks: the full K1 pass at N=%d (biased) %.6f ms; bodies %d and "
          "%d coincident" % (MAIN_N, whole_ms, MAIN_N // 2 - 1, MAIN_N // 2))
    launches, worst, clear = {}, 0.0, 0
    for layout in EMU_LAYOUTS:
        name = "x".join(map(str, layout[1:])) + " " + layout[0]
        err, launches[name], _ = _check_layout(cfg, st, layout, whole,
                                               whole_ms)
        worst = max(worst, err)
        if layout[0] != "allgather":
            flags = _rank_flags(st, layout)
            print("ranks %-13s tagged flags set %d of %d (%s)"
                  % (name, sum(flags), len(flags),
                     "".join("1" if f else "0" for f in flags)))
            if not any(flags):
                raise AssertionError("%s: no rank saw the placed pair" % name)
            clear += len(flags) - sum(flags)
    # A grid of one row or one column puts every body in each rank's
    # groups; the rings and the 2x2 grid must leave some flags clear.
    if not clear:
        raise AssertionError("ranks: every tagged flag was set")
    big = _emulation_state(BIG_N, dev)
    bb = _bodies(big)
    flag = cuda_step.any_coincident(big.x, big.y, big.mass)
    whole_big = cuda_step.block_forces_streamed(cfg, *bb, *bb, biased=flag)
    whole_big_ms = _time_ms(lambda: cuda_step.block_forces_streamed(
        cfg, *bb, *bb, biased=flag), 3, warmup=1)
    _, k2, _ = _check_layout(cfg, big, ("allgather", 2), whole_big,
                             whole_big_ms, kernel=K2)
    return launches, k2, worst


def phase_sabotage_ranks(dev):
    """Phase B must be able to fail: rank 1's row_g0 one tile (128) low
    flips the kick of the pair across the boundary of 2 all-gather ranks,
    and the ranks together must then disagree with the single-device pass,
    or this phase raises."""
    from parallel_nbody_tpu_torch.ops import cuda_step
    cfg = _cfg("float32")
    st = _emulation_state(MAIN_N, dev)
    b = _bodies(st)
    whole = cuda_step.block_forces(cfg, *b, *b, biased=True)

    def shifted(cfg, *args, row_g0, **kw):
        return cuda_step.block_forces_auto(
            cfg, *args, row_g0=row_g0 - (cuda_step.TILE if row_g0 else 0),
            **kw)

    with _ranks_through(shifted):
        try:
            _check_layout(cfg, st, ("allgather", 2), whole, 1.0)
        except AssertionError as e:
            print("sabotage ranks: tripped as it must (%s)" % e)
            return
    raise AssertionError("sabotage ranks: rank 1's row_g0 one tile off "
                         "agreed with the single-device pass")


def phase_dir_checkpoint(tmp, arena, dev):
    """Phase D on the card: ``--checkpoint`` into a directory at CKPT_STEPS
    at world size 1, ``--resume`` to CKPT_TOTAL: stdout byte-equal to the
    uninterrupted run's.  Returns (K1 launches of the resumed
    run, save ms, load ms) — the two from save_state_dcp / load_state_dcp
    of the N=MAIN_N state, host clock, device synchronized."""
    from parallel_nbody_tpu_torch.utils import checkpoint as ckpt
    base = [str(MAIN_N), "0", arena]
    flags = ["--no-clamp", "--pallas"]
    ck = os.path.join(tmp, "ck_dir")
    full, _, _ = _k1_run(base + [str(CKPT_TOTAL)] + flags)
    _k1_run(base + [str(CKPT_STEPS)] + flags + ["--checkpoint=" + ck])
    resumed, _, k1 = _k1_run(base + [str(CKPT_TOTAL)] + flags
                             + ["--resume=" + ck])
    if resumed != full:
        raise AssertionError("directory checkpoint: the resumed run's "
                             "stdout differs from the uninterrupted run's")
    t0 = time.perf_counter()
    state, step, n_real = ckpt.load_state_dcp(ck, dev, torch.float32)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ckpt.save_state_dcp(os.path.join(tmp, "ck_dir2"), state, step, n_real)
    save_ms = (time.perf_counter() - t0) * 1e3
    print("directory checkpoint N=%d: %d + %d steps byte-equal to %d "
          "uninterrupted (K1 %d launches resumed); save_state_dcp %.3f ms, "
          "load_state_dcp %.3f ms" % (MAIN_N, CKPT_STEPS,
                                      CKPT_TOTAL - CKPT_STEPS, CKPT_TOTAL,
                                      k1, save_ms, load_ms))
    if k1 != CKPT_TOTAL - CKPT_STEPS + 1:
        raise AssertionError("directory checkpoint: K1 launched %d times"
                             % k1)
    return k1, save_ms, load_ms


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


def _symmetric_times(cfg, b, off, on, label):
    """The symmetric pass (kernel and fold) beside K1's one-sided kernel on
    the same bodies (``block_forces_one_sided``), both flags, and the fold
    alone."""
    from parallel_nbody_tpu_torch.ops import cuda_step
    n = b[0].shape[0]
    ws = torch.zeros((-(-n // cuda_step.SYMMETRIC_TILE), 2, n),
                     dtype=torch.float32, device=b[0].device)
    times = {
        label + "kernel": _time_ms(lambda: cuda_step.block_forces_one_sided(
            cfg, *b, *b, biased=off), 20),
        label + "kernel_biased": _time_ms(
            lambda: cuda_step.block_forces_one_sided(cfg, *b, *b, biased=on),
            20),
        label + "symmetric": _time_ms(lambda: cuda_step.block_forces(
            cfg, *b, *b, biased=off), 20),
        label + "symmetric_biased": _time_ms(lambda: cuda_step.block_forces(
            cfg, *b, *b, biased=on), 20),
        label + "symmetric_fold": _time_ms(lambda: cuda_step.band_fold(
            cfg, ws, b[2]), 20),
    }
    return times


def phase_timing(dev):
    """K1 (one-sided) and the symmetric pass at MAIN_N and SYM_BIG_N, the
    plain version, the flag, the step, and engine.run's rate."""
    from parallel_nbody_tpu_torch.models.engine import run, step
    from parallel_nbody_tpu_torch.ops import cuda_step
    from parallel_nbody_tpu_torch.state import init_state
    from parallel_nbody_tpu_torch.utils.output import pair_interactions
    cfg = _cfg("float32")
    st = init_state(MAIN_N, cfg, device=dev)
    b = _bodies(st)
    off = torch.zeros((), dtype=torch.bool, device=dev)
    on = torch.ones((), dtype=torch.bool, device=dev)
    times = _symmetric_times(cfg, b, off, on, "")
    big = _symmetric_times(cfg, _bodies(init_state(SYM_BIG_N, cfg,
                                                   device=dev)),
                           off, on, "big_")
    times.update({
        "plain": _time_ms(lambda: cuda_step.block_forces_reference(
            cfg, *b, *b, biased=off), 3, warmup=1),
        "any_coincident": _time_ms(lambda: cuda_step.any_coincident(
            st.x, st.y, st.mass), 20),
        "step": _time_ms(lambda: step(cfg, st), 20),
    })
    for name, ms in times.items():
        print("time N=%d fp32 %-22s %.6f ms" % (MAIN_N, name, ms))
    for name, ms in big.items():
        print("time N=%d fp32 %-22s %.6f ms" % (SYM_BIG_N, name[4:], ms))
    times.update(big)
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
    """A probe kernel vs its plain version in the kernel's order on the
    card.  Returns (max |error|, ms of the plain version's call)."""
    got = module.probe_forces(variant, *args, **tiles)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    *want, xmag, ymag = module.probe_forces_kernel_order(
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
    """P1 and P2: every variant's kernel against its plain version in the
    kernel's order (N=4096 independent, square with coincident bodies, and
    fed back; N=384 and N=1152 square, which neither the row block nor the
    column split divides; then the drivers' own inputs at N=65536), both
    drivers at N=65536, and K1 on the drivers' inputs in the same run."""
    from parallel_nbody_tpu_torch.benchmarks import _probe
    from parallel_nbody_tpu_torch.benchmarks import bias_variants_probe as p2
    from parallel_nbody_tpu_torch.benchmarks import roofline_probe as p1
    from parallel_nbody_tpu_torch.ops import cuda_step
    main = {}
    for module in (p1, p2):
        ind = _probe_inputs(4096, 0, dev)
        square = _probe_inputs(4096, 1, dev, square=True)
        ragged = _probe_inputs(384, 2, dev)
        ragged_square = _probe_inputs(1152, 3, dev, square=True)
        big = _probe.inputs(PROBE_N, dev)
        for variant in module.VARIANTS:
            _compare_probe(module, variant, ind, "N=4096", TOL_PROBE)
            _compare_probe(module, variant, square, "N=4096 square 128/256",
                           TOL_PROBE, tile_i=128, tile_j=256)
            _compare_probe(module, variant, ragged, "N=384 128/128",
                           TOL_PROBE, tile_i=128, tile_j=128)
            _compare_probe(module, variant, ragged_square,
                           "N=1152 square 128/384", TOL_PROBE,
                           tile_i=128, tile_j=384)
            xf, yf = module.probe_forces_reference(variant, *ind)
            _compare_probe(module, variant, [xf, yf] + ind[2:],
                           "N=4096 fed back", TOL_PROBE)
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
    k1 = {"unbiased": _time_ms(lambda: cuda_step.block_forces_one_sided(
              cfg, *big, biased=off), 20),
          "biased": _time_ms(lambda: cuda_step.block_forces_one_sided(
              cfg, *big, biased=on), 20)}
    print("time N=%d on the probes' inputs: K1 unbiased %.6f ms, K1 biased "
          "%.6f ms; P1 full %.3f ms (%.4f of K1 unbiased); P2 r2 %.3f ms "
          "(%.4f of K1 unbiased)"
          % (PROBE_N, k1["unbiased"], k1["biased"], ms1["full"],
             ms1["full"] / k1["unbiased"], ms2["r2"],
             ms2["r2"] / k1["unbiased"]))
    # Each variant once more with CUDA events on the same inputs as K1 (no
    # feedback), so the probes and K1 compare on one footing.
    events = {}
    for module in (p1, p2):
        for variant in module.VARIANTS:
            ms = _time_ms(lambda: module.probe_forces(
                variant, *big, tile_i=PROBE_TILE, tile_j=PROBE_TILE), 10)
            events[module.NAME, variant] = ms
            print("time N=%d events %-19s %-11s %.6f ms (%.4f of K1 "
                  "unbiased)" % (PROBE_N, module.NAME, variant, ms,
                                 ms / k1["unbiased"]))
    kernels = {"P1": dict(ms=ms1["full"], launches=launches1,
                          max_abs_err=main["roofline_probe", "full"][0],
                          plain_ms=main["roofline_probe", "full"][1]),
               "P2": dict(ms=ms2["r2"], launches=launches2,
                          max_abs_err=main["bias_variants_probe", "r2"][0],
                          plain_ms=main["bias_variants_probe", "r2"][1])}
    return events, kernels


def _sass_census():
    """The fp32 pair loops' instructions per pair (benchmarks/sass_census),
    with K1's and K2's three loops told apart.  Checks that each of those
    loops holds no FSETP (neither the old per-pair dsqr == 0 test nor the
    rsqrtf wrapper) and no branch but its own, and that every probe loop
    passes ``sass_census.probe_loop_faults``: no FSETP, a pass of 8 columns
    by R rows (one MUFU a pair where the variant takes an rsqrt), and every
    column load kept (`full`, `no_rsqrt` and `mem_only` read all four
    values of each column, `no_soften` three).  Returns {(kernel, role):
    instructions per pair} of K1's and K2's fp32 loops (plain accum) and
    {(kernel, "probe"): sorted instructions per pair of each loop} of the
    probe kernels (bias_cond has two)."""
    from parallel_nbody_tpu_torch.benchmarks import bias_variants_probe as p2
    from parallel_nbody_tpu_torch.benchmarks import roofline_probe as p1
    from parallel_nbody_tpu_torch.benchmarks import sass_census
    if sass_census.cuobjdump() is None:
        print("sass census: cuobjdump not found, skipped")
        return {}
    ipp = {}
    for lib in ("kernels", "probes", "trig"):
        rows = sass_census.census(sass_census.library_sass(lib))
        roles = sass_census.loop_roles(rows)
        for row in rows:
            name, start, _, _, ops = row
            if "<d" in name or "bfloat16" in name:
                continue  # the fp32 loops are the ones the probes ablate
            role = roles.get((name, start), "")
            print("sass census %s" % sass_census.format_row(row, role))
            if name.startswith(sass_census.TRIG_KERNEL):
                if role != "trig":
                    raise AssertionError("%s: no single trig loop" % name)
                ipp[sass_census.TRIG_KERNEL, "trig"] = row
            if name.startswith(sass_census.FORCE_KERNELS):
                if not role or ops["FSETP"] or ops["BRA"] != 1:
                    raise AssertionError(
                        "%s loop %x (%s): FSETP %d, BRA %d"
                        % (name, start, role or "no role", ops["FSETP"],
                           ops["BRA"]))
                if name.endswith("<fLb0>"):
                    ipp[name.split("<")[0], role] = \
                        sass_census.instr_per_pair(row)
            if name.startswith(sass_census.SYMMETRIC_KERNEL):
                # One rsqrt a pair, and no rsqrtf wrapper.
                if not role or ops["FSETP"] or ops["MUFU"] != row[3]:
                    raise AssertionError(
                        "%s loop %x (%s): FSETP %d, MUFU %d for %d pairs"
                        % (name, start, role or "no role", ops["FSETP"],
                           ops["MUFU"], row[3]))
                if name.endswith("<f>"):
                    ipp[sass_census.SYMMETRIC_KERNEL, role] = \
                        sass_census.instr_per_pair(row)
            if name.startswith(("roofline_probe", "bias_probe")):
                faults = sass_census.probe_loop_faults(row)
                if faults:
                    raise AssertionError("%s loop %x: %s"
                                         % (name, start, "; ".join(faults)))
                ipp[name, "probe"] = tuple(sorted(
                    ipp.get((name, "probe"), ())
                    + (sass_census.instr_per_pair(row),)))
    missing = [(k, r) for k in sass_census.FORCE_KERNELS
               for r in sass_census.ROLES if (k, r) not in ipp]
    missing += [(sass_census.SYMMETRIC_KERNEL, r)
                for r in sass_census.ROLES + sass_census.SYMMETRIC_ROLES
                if (sass_census.SYMMETRIC_KERNEL, r) not in ipp]
    missing += [(k, "probe") for k in (
        sass_census.probe_kernel_name(m.NAME, v)
        for m in (p1, p2) for v in m.VARIANTS)
        if (k, "probe") not in ipp]
    if (sass_census.TRIG_KERNEL, "trig") not in ipp:
        missing.append((sass_census.TRIG_KERNEL, "trig"))
    if missing:
        raise AssertionError("sass census: no loop for %s" % missing)
    return ipp


def _issue_report(ipp, issue_hz, times, times_big, probe_events):
    """Each force kernel's times at its main shape beside the issue bound of
    its loops (instructions per pair from the census, at the maximum SM
    clock), the biased/unbiased ratio, and the biased-unbiased gap beside
    any_coincident's time; then every probe variant's time at PROBE_N
    (CUDA events, tiles PROBE_TILE) beside its loop's issue bound.  For
    bias_cond, whose kernel runs a constant-bias loop on all but the
    overlapping tiles and a per-pair loop on those (the PROBE_TILE-wide
    diagonal blocks, PROBE_TILE / PROBE_N of the pairs), both loops are
    printed and the bound takes their count weighted by those pairs."""
    from parallel_nbody_tpu_torch.benchmarks import sass_census
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
    for n, label in ((MAIN_N, ""), (SYM_BIG_N, "big_")):
        _symmetric_issue(ipp, issue_hz, n, times[label + "symmetric"],
                         times[label + "symmetric_biased"],
                         times[label + "symmetric_fold"])
    for (probe, variant), ms in probe_events.items():
        kernel = sass_census.probe_kernel_name(probe, variant)
        if (kernel, "probe") not in ipp:
            continue
        loops = ipp[kernel, "probe"]
        count, note = loops[0], ""
        if len(loops) == 2:
            per_pair = PROBE_TILE / PROBE_N
            count = loops[0] * (1 - per_pair) + loops[1] * per_pair
            note = (" (constant-bias loop %.3f, per-pair loop %.3f on %.6f "
                    "of the pairs)" % (loops[0], loops[1], per_pair))
        elif len(loops) != 1:
            raise AssertionError("%s: %d pair loops" % (kernel, len(loops)))
        bound = count * PROBE_N ** 2 / WARP / issue_hz * 1e3
        print("issue %s %s N=%d: %.6f ms, issue bound %.3f instr/pair%s "
              "%.6f ms (%.1f%% of the issue rate)"
              % (probe, variant, PROBE_N, ms, count, note, bound,
                 100 * bound / ms))


def _trig_issue(ipp, issue_hz, times):
    """The parity pass's times (phase_trig) at TRIG_SMALL_N and MAIN_N
    beside its loop's issue bound: each thread evaluates one ordered pair a
    pass, N**2 pairs, at the larger of the loop's instructions and twice its
    FP64 instructions a warp pass (``sass_census.issue_cycles_per_pair``;
    the count includes the loop's out-of-line slow paths, so the bound is a
    little high).  Returns {"n<N>": (instructions, FP64 instructions, bound
    ms)}."""
    from parallel_nbody_tpu_torch.benchmarks import sass_census
    row = ipp.get((sass_census.TRIG_KERNEL, "trig"))
    out = {}
    for n in (TRIG_SMALL_N, MAIN_N):
        ms = times["ms_n%d" % n]
        if row is None:
            print("issue parity pass N=%d: %.6f ms" % (n, ms))
            continue
        bound = (sass_census.issue_cycles_per_pair(row) * n * n / WARP
                 / issue_hz * 1e3)
        print("issue parity pass N=%d: %.6f ms; %.3f instr/pair (FP64 %.3f): "
              "issue bound %.6f ms (%.1f%% of the issue rate)"
              % (n, ms, sass_census.instr_per_pair(row),
                 sass_census.fp64_per_pair(row), bound, 100 * bound / ms))
        out["n%d" % n] = (sass_census.instr_per_pair(row),
                          sass_census.fp64_per_pair(row), bound)
    return out


def _symmetric_issue(ipp, issue_hz, n, t_off, t_on, t_fold):
    """The symmetric pass's times at n beside its issue bound: the
    unordered pairs of the tile pairs off the diagonal at the census count
    of its symmetric loops, the diagonal tiles' ordered pairs at K1's loop
    count (per-pair bias on the 128-wide blocks of the diagonal, constant
    bias on the rest when biased)."""
    from parallel_nbody_tpu_torch.benchmarks import sass_census
    from parallel_nbody_tpu_torch.ops import cuda_step
    tile = cuda_step.SYMMETRIC_TILE
    nt = -(-n // tile)
    off_pairs = nt * (nt - 1) // 2 * tile * tile
    diag_pairs = nt * tile * tile
    per_pair = cuda_step.TILE / tile  # of the diagonal's pairs
    k = sass_census.SYMMETRIC_KERNEL
    line = ("issue symmetric N=%d: unbiased %.6f ms, biased %.6f ms (fold "
            "%.6f ms, %.2f%% of the unbiased pass); %d tile pairs, %d on "
            "the diagonal" % (n, t_off, t_on, t_fold, 100 * t_fold / t_off,
                              nt * (nt + 1) // 2, nt))
    if ipp:
        bound = {}
        for biased, sym, diag in (
                (False, ipp[k, "symmetric unbiased"], ipp[k, "unbiased"]),
                (True, ipp[k, "symmetric constant bias"],
                 ipp[k, "constant bias"] * (1 - per_pair)
                 + ipp[k, "per-pair bias"] * per_pair)):
            bound[biased] = ((off_pairs * sym + diag_pairs * diag) / WARP
                             / issue_hz * 1e3)
        line += ("; issue bound %.3f / %.3f instr per unordered pair: "
                 "%.6f ms (%.1f%% of the issue rate, kernel and fold), "
                 "biased %.6f ms (%.1f%%)"
                 % (ipp[k, "symmetric unbiased"],
                    ipp[k, "symmetric constant bias"], bound[False],
                    100 * bound[False] / t_off, bound[True],
                    100 * bound[True] / t_on))
    print(line)


def _reset_counts():
    from parallel_nbody_tpu_torch.ops import cuda_step
    _zero_passes()
    cuda_step.block_forces_streamed.launches = 0
    torch.cuda.synchronize()
    return time.perf_counter()


def _read_counts(label, t0, want_k1, want_k2):
    """The counts since ``_reset_counts``, held to what the path must
    launch; prints the path's wall time."""
    from parallel_nbody_tpu_torch.ops import cuda_step
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    k1 = _passes()
    k2 = cuda_step.block_forces_streamed.launches
    print("%s: %.1f s, launches K1 %d symmetric %d K2 %d"
          % (label, seconds, k1.k1, k1.symmetric, k2))
    if (k1, k2) != (want_k1, want_k2):
        raise AssertionError("%s: launched K1 %d and K2 %d times, expected "
                             "%d and %d" % (label, k1, k2, want_k1, want_k2))
    return k1, k2


def phase_hw_validate(dev):
    """The on-card accuracy gate (benchmarks/hw_validate) in-process at its
    full sizes: every case within the JAX gate's tolerances of float64, the
    programs against the fused run, the gravity flip detected.  One line
    per case with its worst error beside its tolerance.  Returns the
    (K1, K2) launches of the gate's kernel paths: cases A, F, sabotage and
    the resident random cases through K1; B, B', the streamed random case,
    C (two force passes and its run) and the three programs through K2."""
    from parallel_nbody_tpu_torch.benchmarks import hw_validate as hv
    from parallel_nbody_tpu_torch.ops import cuda_step
    t0 = _reset_counts()
    verdict = hv.run_gate(dev, log=lambda s: print("hw_validate: " + s))
    steps = verdict["steps"]
    specs = verdict["random_cases"]["cases"]
    want_k1 = 3 * steps + sum(c["steps"] for c in specs
                              if c["variant"] == "resident")
    want_k2 = 2 * steps + sum(c["steps"] for c in specs
                              if c["variant"] == "streamed")
    # Case C's two force passes, its run and the three programs' runs: K2
    # at the full N_LARGE, K1 below the threshold.
    if verdict["n_large"] > cuda_step.STREAMED_ABOVE:
        want_k2 += 2 + steps + 3 * steps
    else:
        want_k1 += 2 + steps + 3 * steps
    launches = _read_counts("hw_validate", t0, want_k1, want_k2)
    for line in hv.summary_lines(verdict):
        print("hw_validate " + line)
    print("hw_validate: N=%d band %d: %d bands; %s"
          % (verdict["n_small"], verdict["band"], verdict["bands"],
             "PASS" if verdict["ok"] else "FAIL"))
    if not verdict["ok"] or verdict["bands"] != 4:
        raise AssertionError("hw_validate: the gate failed: %s"
                             % json.dumps(verdict["cases"]))
    return launches


# The drift study's depth here: 1000 steps, the energy at 0, 500 and 1000
# (the full 5000 are run by hand, benchmarks/drift_study.py).
DRIFT_STEPS = 1000
# Bounds of phase_drift: the force operator as the gate's TOL_FORCE for
# fp32 and 1e-2 for bf16 (inputs rounded to 8 bits: 3.9e-3 on the TPU),
# and the energy within 5% of E0, as tests/test_torch_drift.py bounds it.
DRIFT_FORCE_BF16, DRIFT_ENERGY = 1e-2, 0.05


def phase_drift(dev):
    """The energy-drift study (benchmarks/drift_study) at N=65536 for fp32
    plain, fp32 compensated and bf16 through K1, DRIFT_STEPS deep.  Returns
    K1's launches: per mode one force pass, a warm-up step, 3 timed chunks
    and the steps."""
    from parallel_nbody_tpu_torch.benchmarks import drift_study as ds
    from parallel_nbody_tpu_torch.benchmarks.hw_validate import TOL_FORCE
    sizes = ds.FULL_SIZES._replace(steps=DRIFT_STEPS)
    t0 = _reset_counts()
    rec = ds.run_study(dev, sizes, log=lambda s: print("drift: " + s))
    per_mode = 2 + ds.TIMING_REPS * sizes.chunk + sizes.steps
    k1, _ = _read_counts("drift", t0, len(ds.MODES) * per_mode, 0)
    for mode in ds.MODES:
        f = rec["force_operator_vs_fp64"][mode]
        e = rec["energy"][mode]
        drifts = [e["drift_%d" % t] for t in ds.energy_at(sizes.steps)[1:]]
        print("drift %-11s N=%d: force vs fp64 max_rel %.6e mean_rel %.6e; "
              "E0 %.6e, drift %s; %.6f ms/step"
              % (mode, rec["n"], f["max_rel"], f["mean_rel"], e["E0"],
                 " ".join("%.6e" % d for d in drifts),
                 rec["timings"][mode] * 1e3))
        bound = DRIFT_FORCE_BF16 if mode == "bfloat16" else TOL_FORCE
        if not (f["max_rel"] < bound and all(d < DRIFT_ENERGY
                                             for d in drifts)):
            raise AssertionError("drift %s: force max_rel %.6e (bound %g), "
                                 "drift %s" % (mode, f["max_rel"], bound,
                                               drifts))
    print("drift: init_quantization %s" % rec["init_quantization"])
    return k1


ANIMATE_N, ANIMATE_STEPS, ANIMATE_EVERY = 4096, 200, 50


def phase_animate(dev, tmp):
    """examples/animate on the card: N=4096 glibc, 200 steps through K1,
    recorded every 50, four PPMs each byte-equal to the CPU's render of the
    same recorded positions.  Returns K1's launches (one a step)."""
    from parallel_nbody_tpu_torch.examples import animate
    from parallel_nbody_tpu_torch.ops.render import render_frame
    from parallel_nbody_tpu_torch.utils import ppm
    outdir = os.path.join(tmp, "frames")
    t0 = _reset_counts()
    cfg, xs, ys, radius, paths = animate.record(
        ANIMATE_N, ANIMATE_STEPS, ANIMATE_EVERY, outdir, dev)
    k1, _ = _read_counts("animate", t0, ANIMATE_STEPS, 0)
    if len(paths) != ANIMATE_STEPS // ANIMATE_EVERY:
        raise AssertionError("animate wrote %d frames" % len(paths))
    for i, path in enumerate(paths):
        got = ppm.read_pixels(ppm.read_header(path))
        want = render_frame(cfg, xs[i].cpu(), ys[i].cpu(), radius.cpu(),
                            ANIMATE_N).numpy()
        lit = int(want.any(axis=2).sum())
        print("animate %s: %d lit pixels, byte-equal to the CPU's render: "
              "%s" % (os.path.basename(path), lit, np.array_equal(got,
                                                                  want)))
        if not np.array_equal(got, want) or not lit:
            raise AssertionError("animate %s differs from the CPU's render"
                                 % path)
    return k1


def phase_entry(dev):
    """entry()'s fn on the card: one step, bit-equal to engine.step on the
    same state, K1 launched once."""
    from parallel_nbody_tpu_torch.entry import N_ENTRY, entry
    from parallel_nbody_tpu_torch.models.engine import step
    fn, (state,) = entry()
    if state.x.device != dev or state.n != N_ENTRY:
        raise AssertionError("entry state on %s with %d bodies"
                             % (state.x.device, state.n))
    t0 = _reset_counts()
    got = fn(state)
    k1, _ = _read_counts("entry", t0, 1, 0)
    want = step(_cfg("float32"), state)
    equal = all(torch.equal(g, w) for g, w in zip(got, want))
    print("entry: fn(state) at N=%d bit-equal to engine.step: %s"
          % (N_ENTRY, equal))
    if not equal:
        raise AssertionError("entry: fn(state) differs from engine.step")
    return k1


# The speed tools' phases: the autotune subset (band sizes, bands,
# threshold sizes, threshold bands) and the probes' repetitions.
AUTOTUNE_SUBSET = ((262144,), (32768, 65536), (65536, 131072), (65536,))
PROBE_REPS = 1
HUGE_SMOKE_N = 1 << 20
# The huge-N path (phase_hosted): (a) engine.step against the row-chunked
# step; (b) one K2 row chunk at HUGE_CAP_N, its first HEAD_ROWS rows against
# K2 on those rows alone and PLAIN_ROWS rows, from a 128-aligned offset in
# the chunk, against the plain version; (c) the CLI with and without
# NBODY_HUGE_THRESHOLD, K2 in launches of HOSTED_CLI_CHUNK rows with it.
HOSTED_N, HOSTED_CHUNK = 1 << 21, 262144
HUGE_CAP_N, HUGE_CAP_CHUNK, HUGE_CAP_ROW0 = 26_000_000, 524288, 13_000_000
HEAD_ROWS, PLAIN_ROWS, PLAIN_OFFSET = 128, 8, 262144
HOSTED_CLI_N, HOSTED_CLI_STEPS, HOSTED_CLI_CHUNK = 262144, 3, 65536


def phase_bench(dev):
    """The port's headline benchmark (benchmarks/bench) in-process on the
    card: its one JSON line, parsed, with the root bench.py's keys and a
    fingerprint of this card; K1 launched once a step of the warm-up and
    the REPS timed runs, K2 never.  Returns (the line, K1 launches)."""
    from parallel_nbody_tpu_torch.benchmarks import bench
    out = io.StringIO()
    t0 = _reset_counts()
    with contextlib.redirect_stdout(out), \
            mock.patch.dict(os.environ, {bench.ROWS_ENV: ""}):
        rc = bench.main(["bench"])
    k1, _ = _read_counts("bench", t0, (1 + bench.REPS) * bench.STEPS, 0)
    lines = out.getvalue().strip().splitlines()
    print("bench: rc %d, %s" % (rc, lines[-1] if lines else "no line"))
    if rc != 0 or len(lines) != 1:
        raise AssertionError("bench: rc %d, lines %s" % (rc, lines))
    line = json.loads(lines[0])
    if set(line) != {"metric", "value", "unit", "vs_baseline",
                     "fingerprint"}:
        raise AssertionError("bench: keys %s" % sorted(line))
    if line["fingerprint"]["name"] != torch.cuda.get_device_name(dev) or \
            "N=%d" % bench.N not in line["metric"]:
        raise AssertionError("bench: not the card's headline: %s" % line)
    return line, k1


def phase_perf_gate(line):
    """The perf gate (benchmarks/perf_gate) on phase_bench's line: PASS at
    the floor; then the gate's own run of the benchmark in a subprocess
    with the sabotage (each force pass in K1 launches of SABOTAGE_ROWS
    rows) must trip it."""
    from parallel_nbody_tpu_torch.benchmarks import bench, perf_gate
    t0 = time.perf_counter()
    passed = perf_gate.gate(line, perf_gate.FLOOR_PAIRS_PER_S)
    sabotage = perf_gate.gate(
        perf_gate.run_bench(dict(os.environ, **{
            bench.ROWS_ENV: str(perf_gate.SABOTAGE_ROWS)})),
        perf_gate.FLOOR_PAIRS_PER_S)
    for label, rec in (("headline", passed), ("sabotage", sabotage)):
        print("perf gate %s: %s %s" % (label, rec["status"], json.dumps(
            {k: v for k, v in rec.items() if k not in ("status", "bench")})))
    print("perf gate: %.1f s" % (time.perf_counter() - t0))
    if passed["status"] != "PASS" or sabotage["status"] != "REGRESSION":
        raise AssertionError("perf gate: headline %s, sabotage %s"
                             % (passed["status"], sabotage["status"]))
    return passed, sabotage


def phase_scaling(dev):
    """The scaling grid (benchmarks/run_benchmarks) in full on the card:
    seq_grid, the K1/K2 grid to N=2097152 with the row-sample holds of K2's
    first force pass at N >= HOLD_FROM, and the shard grid's reason for
    being skipped on one card.  Returns (K1, K2) launches: a warm-up step
    and k steps a size, and one held pass from HOLD_FROM up."""
    from parallel_nbody_tpu_torch.benchmarks import run_benchmarks as rb
    from parallel_nbody_tpu_torch.ops import cuda_step
    want = [0, 0]
    for n in rb.GRID_SIZES:
        want[n > cuda_step.STREAMED_ABOVE] += 1 + rb.grid_steps(n) + (
            n >= rb.HOLD_FROM)
    t0 = _reset_counts()
    rep = rb.report(dev, log=lambda s: print("scaling: " + s))
    launches = _read_counts("scaling", t0, *want)
    for n, row in rep["seq_grid"].items():
        print("scaling seq_grid N=%s: %s" % (n, json.dumps(row)))
    held = [n for n, row in rep["cuda_grid"].items() if "hold" in row]
    print("scaling: held N=%s; shard grid: %s"
          % (held, json.dumps(rep["shard_grid"])))
    if held != [n for n in rb.GRID_SIZES if n >= rb.HOLD_FROM] or \
            not all(rep["cuda_grid"][n]["hold"]["ok"] for n in held):
        raise AssertionError("scaling: holds %s" % held)
    if torch.cuda.device_count() == 1 and set(rep["shard_grid"]) != {
            "skipped"}:
        raise AssertionError("scaling: shard grid on one card: %s"
                             % rep["shard_grid"])
    return launches


def phase_k2_probes(dev):
    """ring_bias_probe, bf16_stream_probe and a subset of autotune on the
    card at PROBE_REPS repetitions.  Returns (K1, K2) launches: a warm-up
    and PROBE_REPS passes for every timed case."""
    from parallel_nbody_tpu_torch.benchmarks import autotune
    from parallel_nbody_tpu_torch.benchmarks import bf16_stream_probe as bf
    from parallel_nbody_tpu_torch.benchmarks import ring_bias_probe as rbp
    per_case = 1 + PROBE_REPS
    want = [0, 0]
    for _, _, _, kernel, _ in rbp.CASES:
        want[kernel == "block_forces_streamed"] += 2 * per_case
    want[1] += 2 * per_case  # bf16 probe: fp32 and bf16 through K2 at 1M
    band_sizes, bands, sizes, threshold_bands = AUTOTUNE_SUBSET
    want[1] += per_case * sum(b <= n for n in band_sizes for b in bands)
    want[0] += per_case * len(sizes)
    want[1] += per_case * sum(b <= n for n in sizes for b in threshold_bands)
    t0 = _reset_counts()
    ring = rbp.probe(dev, PROBE_REPS, log=lambda s: print("ring_bias " + s))
    b16 = bf.probe(dev, reps=PROBE_REPS, log=lambda s: print("bf16 " + s))
    tune = autotune.sweep(dev, PROBE_REPS, AUTOTUNE_SUBSET,
                          log=lambda s: print("autotune " + s))
    launches = _read_counts("k2 probes", t0, *want)
    for label, case in ring["cases"].items():
        print("ring_bias %s: bias costs %.2f%%" % (label,
                                                  case["bias_cost_pct"]))
    print("bf16 stream probe N=%d: bf16 %.4fx fp32's speed; autotune best "
          "%s" % (b16["n"], b16["bf16_speedup"], json.dumps(tune["best"])))
    return launches


def phase_huge(dev, tmp):
    """benchmarks/huge_n's argv (``N row_chunk out.ppm``) at
    N=HUGE_SMOKE_N with the tool's default row chunk: one step through K2
    in ceil(N / row_chunk) launches, finite, and a frame with lit pixels.
    Returns K2's launches."""
    from parallel_nbody_tpu_torch.benchmarks import huge_n
    out_ppm = os.path.join(tmp, "huge.ppm")
    rec_path = os.path.join(tmp, "huge.json")
    out = io.StringIO()
    t0 = _reset_counts()
    with contextlib.redirect_stdout(out):
        rc = huge_n.main(["huge_n", str(HUGE_SMOKE_N), str(huge_n.ROW_CHUNK),
                          out_ppm, "--out=" + rec_path])
    for line in out.getvalue().splitlines():
        print("huge_n: " + line)
    chunks = -(-HUGE_SMOKE_N // huge_n.ROW_CHUNK)
    _, k2 = _read_counts("huge_n", t0, 0, chunks)
    with open(rec_path) as f:
        rec = json.load(f)
    if rc != 0 or rec["chunks"] != chunks or not rec["lit_pixels"] or \
            rec["frame"] != out_ppm or not os.path.getsize(out_ppm):
        raise AssertionError("huge_n: rc %d, record %s" % (rc, rec))
    return k2


def _peak(fn, dev):
    """(result, ms, peak bytes allocated above what was allocated before)
    of ``fn()``, by the host clock around a synchronized call."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, torch.cuda.max_memory_allocated(dev) - base


def _workspace_bytes(rows, cols):
    """K2's (bands, 2, rows) fp32 workspace against ``cols`` columns."""
    from parallel_nbody_tpu_torch.ops import cuda_step
    band = cuda_step.band_width(cols, cuda_step.STREAM_BAND)
    return -(-cols // band) * 2 * rows * 4


def _hosted_step(dev):
    """(a): engine.step (one K2 launch) against make_hosted_row_step in
    chunks of HOSTED_CHUNK at N=HOSTED_N, bit-equal, with each one's peak
    memory; then render_frame against render_frame_hosted on the stepped
    state, byte-equal, with theirs.  Returns the chunked step's K2
    launches."""
    from parallel_nbody_tpu_torch.models import engine
    from parallel_nbody_tpu_torch.state import random_state
    cfg = _cfg("float32")
    n = HOSTED_N
    st = random_state(n, cfg, torch.Generator(device=dev).manual_seed(0),
                      device=dev)
    step_fn, warmup = engine.make_hosted_row_step(cfg, n, HOSTED_CHUNK)
    warmup()
    t0 = _reset_counts()
    one, one_ms, one_peak = _peak(lambda: engine.step(cfg, st), dev)
    _read_counts("hosted N=%d engine.step" % n, t0, 0, 1)
    chunks = n // HOSTED_CHUNK
    t0 = _reset_counts()
    got, got_ms, got_peak = _peak(lambda: step_fn(st), dev)
    _, k2 = _read_counts("hosted N=%d row chunks of %d" % (n, HOSTED_CHUNK),
                         t0, 0, chunks)
    equal = all(torch.equal(getattr(one, f), getattr(got, f))
                for f in ("x", "y", "xv", "yv", "xf", "yf"))
    mib = 2.0 ** 20
    print("hosted N=%d: engine.step (1 K2 launch, workspace %.0f MiB) "
          "%.3f ms, peak %.1f MiB; row chunks of %d (%d launches, "
          "workspace %.0f MiB each) %.3f ms, peak %.1f MiB; bit-equal %s"
          % (n, _workspace_bytes(n, n) / mib, one_ms, one_peak / mib,
             HOSTED_CHUNK, chunks, _workspace_bytes(HOSTED_CHUNK, n) / mib,
             got_ms, got_peak / mib, equal))
    if not equal:
        raise AssertionError("hosted: the row-chunked step differs from "
                             "engine.step at N=%d" % n)
    _frames(cfg, got, n, dev)
    return k2


def _huge_chunk(dev):
    """(b): one K2 row chunk of HUGE_CAP_CHUNK rows at row_g0=HUGE_CAP_ROW0
    against all HUGE_CAP_N columns, where one launch over all rows would
    need a workspace of _workspace_bytes(N, N): its time and peak memory,
    its first HEAD_ROWS rows bit-equal to K2 on those rows alone, and
    PLAIN_ROWS rows against the plain version (TOL); beside it, the
    launches that engine.step takes at that N.  Then _frames on the state
    of N bodies.  Returns (K2's launches of the chunk, max |error| against
    the plain version)."""
    from parallel_nbody_tpu_torch.ops import cuda_step
    from parallel_nbody_tpu_torch.state import random_state
    cfg = _cfg("float32")
    n, k, r0 = HUGE_CAP_N, HUGE_CAP_CHUNK, HUGE_CAP_ROW0
    torch.cuda.empty_cache()
    st = random_state(n, cfg, torch.Generator(device=dev).manual_seed(0),
                      device=dev)
    cols = _bodies(st)
    flag = cuda_step.any_coincident(st.x, st.y, st.mass)
    full = _workspace_bytes(n, n)
    total = torch.cuda.get_device_properties(dev).total_memory
    step_rows = cuda_step.streamed_rows(n, torch.float32)
    gb = 1e9
    print("hosted N=%d: one launch's workspace %.3f GB (%.2f GiB) against "
          "total_memory %.3f GB (%.2f GiB); engine.step takes K2 in %d "
          "launches of %d rows (workspace %.3f GB each); the coincidence "
          "flag %s"
          % (n, full / gb, full / 2**30, total / gb, total / 2**30,
             -(-n // step_rows), step_rows, _workspace_bytes(step_rows, n)
             / gb, bool(flag)))

    def rows(lo, hi):
        return [t[lo:hi] for t in cols]

    t0 = _reset_counts()
    (fx, fy), ms, peak = _peak(lambda: cuda_step.block_forces_streamed(
        cfg, *rows(r0, r0 + k), *cols, row_g0=r0, col_g0=0, biased=flag),
        dev)
    _, launches = _read_counts("hosted N=%d row chunk" % n, t0, 0, 1)
    head = cuda_step.block_forces_streamed(
        cfg, *rows(r0, r0 + HEAD_ROWS), *cols, row_g0=r0, col_g0=0,
        biased=flag)
    head_equal = bool(torch.equal(head[0], fx[:HEAD_ROWS])
                      and torch.equal(head[1], fy[:HEAD_ROWS]))
    lo = r0 + PLAIN_OFFSET
    want = cuda_step.block_forces_streamed_reference(
        cfg, *rows(lo, lo + PLAIN_ROWS), *cols, row_g0=lo, col_g0=0,
        biased=flag)
    got = (fx[PLAIN_OFFSET:PLAIN_OFFSET + PLAIN_ROWS],
           fy[PLAIN_OFFSET:PLAIN_OFFSET + PLAIN_ROWS])
    scale = max(float(w.abs().max()) for w in want)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    finite = bool(torch.isfinite(fx).all() and torch.isfinite(fy).all())
    print("hosted N=%d: K2 on rows [%d, %d) x %d columns (workspace "
          "%.3f GB) %.3f ms, peak %.3f GB above the state, %.6e "
          "one-sided pairs/s; first %d rows bit-equal to K2 on them alone "
          "%s; rows [%d, %d) vs the plain version max|err| %.6e /max|F| "
          "%.6e (tol %.1e)"
          % (n, r0, r0 + k, n, _workspace_bytes(k, n) / gb, ms, peak / gb,
             k * n / (ms / 1e3), HEAD_ROWS, head_equal, lo,
             lo + PLAIN_ROWS, err, err / scale, TOL[torch.float32]))
    if not finite or not head_equal or \
            not err <= TOL[torch.float32] * scale:
        raise AssertionError("hosted: the N=%d row chunk is wrong (finite "
                             "%s, head bit-equal %s, max|err| %.6e of "
                             "max|F| %.6e)" % (n, finite, head_equal, err,
                                               scale))
    del fx, fy, head
    _frames(cfg, st, n, dev)
    return launches, err


def _frames(cfg, st, n, dev):
    """render_frame against render_frame_hosted (body chunks of 262144)
    on ``st``: byte-equal and lit, each one's time and peak memory."""
    from parallel_nbody_tpu_torch.ops import render
    b = (st.x, st.y, st.radius)
    whole, whole_ms, whole_peak = _peak(
        lambda: render.render_frame(cfg, *b, n).cpu().numpy(), dev)
    hosted, hosted_ms, hosted_peak = _peak(
        lambda: render.render_frame_hosted(cfg, *b, n), dev)
    mib = 2.0 ** 20
    print("hosted N=%d frames: render_frame %.3f ms, peak %.1f MiB; "
          "render_frame_hosted (body chunks of 262144) %.3f ms, peak "
          "%.1f MiB; byte-equal %s, %d lit pixels"
          % (n, whole_ms, whole_peak / mib, hosted_ms, hosted_peak / mib,
             whole.tobytes() == hosted.tobytes(),
             int(hosted.any(axis=2).sum())))
    if whole.tobytes() != hosted.tobytes() or not hosted.any():
        raise AssertionError("hosted: render_frame_hosted differs from "
                             "render_frame at N=%d" % n)


def _hosted_cli(dev, tmp):
    """(c): the CLI at N=HOSTED_CLI_N with secs_per_update=1 for
    HOSTED_CLI_STEPS steps, without and with NBODY_HUGE_THRESHOLD below N
    (and K2_WORKSPACE_BYTES lowered so that the step takes K2 in launches
    of HOSTED_CLI_CHUNK rows): stdout byte-equal, the first frame's md5
    equal, K2 launched steps + 1 (the discarded warm-up step) times without
    and steps x chunks with.  Returns the huge run's K2 launches."""
    from parallel_nbody_tpu_torch.ops import cuda_step
    from parallel_nbody_tpu_torch.utils import ppm
    arena = os.path.join(tmp, "hosted.ppm")
    ppm.create(arena, 1024, 768)
    argv = [str(HOSTED_CLI_N), "1", arena, str(HOSTED_CLI_STEPS),
            "--no-clamp", "--pallas"]
    chunks = -(-HOSTED_CLI_N // HOSTED_CLI_CHUNK)
    runs = {}
    for label, env, want_k2 in (
            ("one launch", {}, HOSTED_CLI_STEPS + 1),
            ("huge", {"NBODY_HUGE_THRESHOLD": str(HOSTED_CLI_N // 2)},
             HOSTED_CLI_STEPS * chunks)):
        log = os.path.join(tmp, "hosted_%d.log" % len(runs))
        budget = (_workspace_bytes(HOSTED_CLI_CHUNK, HOSTED_CLI_N) if env
                  else cuda_step.K2_WORKSPACE_BYTES)
        t0 = _reset_counts()
        with mock.patch.dict(os.environ, dict(env, NBODY_FRAME_LOG=log)), \
                mock.patch.object(cuda_step, "K2_WORKSPACE_BYTES", budget):
            out, err = _cli(argv, "cuda")
        _, k2 = _read_counts("hosted cli %s" % label, t0, 0, want_k2)
        with open(log) as f:
            md5s = re.findall(r"md5=([0-9a-f]{32})", f.read())
        runs[label] = (out, md5s, k2, _rtime(err))
    (out0, md5s0, k2_0, rt0), (out1, md5s1, k2_1, rt1) = runs.values()
    print("hosted cli: %s; RTIME %.3f s one launch, %.3f s huge (%d chunks "
          "of %d); K2 launches %d and %d; frames %d and %d, first md5 %s "
          "and %s; stdout byte-equal %s"
          % (" ".join(argv), rt0, rt1, chunks, HOSTED_CLI_CHUNK, k2_0, k2_1,
             len(md5s0), len(md5s1), md5s0[:1], md5s1[:1], out0 == out1))
    _state_table(out1, HOSTED_CLI_N)
    if out0 != out1 or not md5s0 or md5s0[:1] != md5s1[:1]:
        raise AssertionError("hosted cli: the huge branch differs from the "
                             "one-launch run")
    return k2_1


def phase_hosted(dev, tmp):
    """The huge-N path: (a) _hosted_step, (b) _huge_chunk, (c)
    _hosted_cli.  Returns ({path: K2 launches, each counted from 0}, the
    row chunk's max |error| against the plain version)."""
    launches = {"hosted step N=%d" % HOSTED_N: _hosted_step(dev)}
    launches["row chunk N=%d" % HUGE_CAP_N], err = _huge_chunk(dev)
    launches["cli huge N=%d" % HOSTED_CLI_N] = _hosted_cli(dev, tmp)
    return launches, err


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
    with contextlib.ExitStack() as stack:
        # Phase C's CPU ranks run beside the build and the comparisons; they
        # are done before the first phase that times the CLI.
        cpu_tmp = stack.enter_context(tempfile.TemporaryDirectory())
        cpu_arena = os.path.join(cpu_tmp, "arena.ppm")
        ppm.create(cpu_arena, 1024, 768)
        pool = concurrent.futures.ThreadPoolExecutor(3)
        stack.callback(pool.shutdown, wait=True, cancel_futures=True)
        cpu_ranks = {task: pool.submit(fn) for task, fn in
                     _cpu_ranks_tasks(cpu_arena, cpu_tmp).items()}
        phase_build()
        max_err_k1 = phase_compare(dev)
        sym_err, sym_plain_ms, sym_plain_ms_big = phase_symmetric(dev)
        phase_sabotage(dev)
        max_err_k2, plain_ms_k2 = phase_compare_streamed(dev)
        phase_compensated(dev)
        phase_bf16(dev)
        phase_coincident(dev)
        trig_times, launches_trig_phase, max_err_trig = phase_trig(dev)
        t_wait = time.perf_counter()
        phase_cpu_ranks(cpu_ranks, cpu_arena, cpu_tmp)
        print("cpu ranks: joined at %.1f s, after %.1f s of waiting"
              % (t_wait - t_start, time.perf_counter() - t_wait))
    with tempfile.TemporaryDirectory() as tmp:
        arena = os.path.join(tmp, "arena.ppm")
        ppm.create(arena, 1024, 768)
        launches_k1, _ = phase_main_path(arena)
        launches_k2 = phase_main_path_streamed(arena)
        launches_trig = phase_main_path_trig(arena)
        render_ms, _ = phase_render(dev)
        launches_frames, _, _, _ = phase_frame_path(tmp, render_ms)
        launches_resumed, _, _ = phase_checkpoint(tmp, arena, dev)
        launches_resumed_dir, _, _ = phase_dir_checkpoint(tmp, arena, dev)
        phase_diagnostics(tmp, arena)
        launches_replay, _, _, known = phase_reference_replay(dev, tmp)
        launches_trig_replay, _, _, _ = phase_reference_replay(dev, tmp,
                                                               trig=True)
    phase_state_streamed(dev)
    times = phase_timing(dev)
    times_big = phase_timing_streamed(dev)
    probe_events, probes = phase_probes(dev)
    ipp = _sass_census()
    _issue_report(ipp, issue_hz, times, times_big, probe_events)
    trig_issue = _trig_issue(ipp, issue_hz, trig_times)
    t_dist = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        launches_world, _, _ = phase_world_of_one(dev, tmp)
    t_ranks = time.perf_counter()
    launches_ranks, launches_ranks_k2, max_err_ranks = \
        phase_emulated_ranks(dev)
    phase_sabotage_ranks(dev)
    print("world of one: %.1f s; emulated ranks and their sabotage: %.1f s"
          % (t_ranks - t_dist, time.perf_counter() - t_ranks))
    t_tools = time.perf_counter()
    launches_gate_k1, launches_gate_k2 = phase_hw_validate(dev)
    launches_drift = phase_drift(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches_animate = phase_animate(dev, tmp)
    launches_entry = phase_entry(dev)
    print("tools (hw_validate, drift, animate, entry): %.1f s"
          % (time.perf_counter() - t_tools))
    t_speed = time.perf_counter()
    line, launches_bench = phase_bench(dev)
    phase_perf_gate(line)
    launches_scaling = phase_scaling(dev)
    launches_probes = phase_k2_probes(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches_huge = phase_huge(dev, tmp)
    print("speed tools (bench, perf gate, scaling, K2 probes, huge_n): "
          "%.1f s" % (time.perf_counter() - t_speed))
    t_hosted = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        launches_hosted, max_err_hosted = phase_hosted(dev, tmp)
    print("hosted (the huge-N path): %.1f s"
          % (time.perf_counter() - t_hosted))
    print("chip_smoke: %.1f s" % (time.perf_counter() - t_start))
    source = "parallel_nbody_tpu_torch/csrc/%s"
    replaces = "parallel_nbody_tpu/ops/pallas_step.py:%d"
    passes = {
        "launches": launches_k1,
        "launches_frame_path": launches_frames,
        "launches_resumed_run": launches_resumed,
        "launches_resumed_dir_run": launches_resumed_dir,
        "launches_world_of_one": launches_world,
        "launches_emulated_ranks": launches_ranks,
        "launches_hw_validate": launches_gate_k1,
        "launches_drift": launches_drift,
        "launches_animate": launches_animate,
        "launches_entry": launches_entry,
        "launches_bench": launches_bench,
        "launches_scaling": launches_scaling[0],
        "launches_k2_probes": launches_probes[0],
        "launches_reference_replay": launches_replay,
    }

    def split(part):
        """block_forces's passes on each path: K1's launches or the
        symmetric pass's (``_Passes``)."""
        return {key: ({k: getattr(v, part) for k, v in n.items()}
                      if isinstance(n, dict) else getattr(n, part))
                for key, n in passes.items()}

    kernels = [{
        "name": "block_forces_kernel",
        "route": "cuda",
        "source": source % "forces.cu",
        "replaces": replaces % 249,
        **split("k1"),
        "reference_replay_known_misses": known,
        "max_abs_err_emulated_ranks": max_err_ranks,
        "max_abs_err": max_err_k1,
        "ms": times["kernel"],
        "ms_biased": times["kernel_biased"],
        "plain_ms": times["plain"],
        "n": MAIN_N,
    }, {
        "name": "block_forces_symmetric_kernel+band_fold_kernel",
        "route": "cuda",
        "source": source % "forces_symmetric.cu",
        "replaces": "none (K1's square fp32 case, each pair once)",
        **split("symmetric"),
        "max_err_rel": sym_err,
        "ms": times["symmetric"],
        "ms_biased": times["symmetric_biased"],
        "ms_fold": times["symmetric_fold"],
        "plain_ms": sym_plain_ms,
        "ms_n%d" % SYM_BIG_N: times["big_symmetric"],
        "ms_biased_n%d" % SYM_BIG_N: times["big_symmetric_biased"],
        "k1_ms_n%d" % SYM_BIG_N: times["big_kernel"],
        "plain_ms_n%d" % SYM_BIG_N: sym_plain_ms_big,
        # The reference's work, as the benchmark's force_roofline_pct counts
        # it: 20 FP32 operations per unordered pair.
        "bound_ms": MAIN_N * (MAIN_N - 1) / 2 * 20 / PEAK_FP32_FLOPS * 1e3,
        "bound_by": "operations",
        "n": MAIN_N,
    }, {
        "name": "band_partials_kernel+band_fold_kernel",
        "route": "cuda",
        "source": source % "forces_streamed.cu",
        "replaces": replaces % 344,
        "launches": launches_k2,
        "launches_emulated_ranks": {"2 allgather": launches_ranks_k2},
        "launches_hw_validate": launches_gate_k2,
        "launches_scaling": launches_scaling[1],
        "launches_k2_probes": launches_probes[1],
        "launches_huge_n": launches_huge,
        "launches_hosted": launches_hosted,
        "max_abs_err_row_chunk_n%d" % HUGE_CAP_N: max_err_hosted,
        "max_abs_err": max_err_k2,
        "ms": times_big["K2"],
        "ms_biased": times_big["K2_biased"],
        "plain_ms": plain_ms_k2,
        "n": BIG_N,
    }, {
        "name": "trig_forces_kernel",
        "route": "cuda",
        "source": source % "forces_trig.cu",
        "replaces": "none (the parity mode's dense path, "
                    "parallel_nbody_tpu_torch/ops/forces.py:89)",
        "launches": launches_trig,
        "launches_phase_trig": launches_trig_phase,
        "launches_reference_replay": launches_trig_replay,
        "max_abs_err": max_err_trig,
        "ms": trig_times["ms_n%d" % MAIN_N],
        "ms_n%d" % TRIG_SMALL_N: trig_times["ms_n%d" % TRIG_SMALL_N],
        "plain_ms_n%d" % TRIG_SMALL_N: trig_times["plain_ms_n%d"
                                                  % TRIG_SMALL_N],
        "dense_ms_n%d" % TRIG_SMALL_N: trig_times["dense_ms_n%d"
                                                  % TRIG_SMALL_N],
        "issue_bound": trig_issue,
        # The reference's work, as the benchmark's force_roofline_pct.trig
        # counts it: 20 FP64 operations per unordered pair.
        "bound_ms": MAIN_N * (MAIN_N - 1) / 2 * 20 / PEAK_FP64_FLOPS * 1e3,
        "bound_by": "operations",
        "n": MAIN_N,
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
        if "bound_ms" not in k:
            k["bound_ms"], k["bound_by"] = _bound(n, n)
        k["library_ms"] = None  # no one PyTorch call computes these
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
