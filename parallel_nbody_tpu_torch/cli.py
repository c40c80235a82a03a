"""Command-line interface with the reference's argv contract.

Reference CLI (nbody-seq.c:386-499):

    num_bodies secs_per_update ppm_output_file steps [--run-xps]

plus the JAX package's extensions, parsed the same way (cli.py of
``parallel_nbody_tpu``):

    --devices=K       shard the body axis over K ranks, one device each
                      (default: 1, or under a launcher every rank it started)
    --comm=MODE       "allgather" (default) or "ring" (blocks travel the ring
                      of ranks); ignored on one device
    --mesh2d=RxC      2-D force-matrix decomposition over an R x C mesh of
                      ranks (overrides --comm; 1x1 is one device)
    --fast            transcendental-free force path
    --pallas          the hand-written CUDA force kernels (implies --fast;
                      the flag keeps the JAX package's name): K1, or K2
                      above 131072 bodies in either block (in fp32 and
                      bf16 with plain sums the symmetric pass in its
                      place).  On a CPU device the kernels' plain PyTorch
                      versions run.
    --trig            with --pallas: the parity mode (the reference's trig
                      force path, which is the default without --pallas)
                      through the parity pass (csrc/forces_trig.cu), on one
                      device and in float64 (the default dtype then, and
                      the only one): the dense path's forces bit for bit,
                      in memory that grows as N, not N^2
    --dtype=T         bfloat16 | float32 | float64 (default: float64 on
                      cpu, float32 on cuda)
    --no-clamp        allow N > 10000 (the reference clamps to MAXBODIES)
    --accum=A         plain | compensated (Kahan folds in the kernels'
                      partial sums; the dense path ignores it)
    --run-xps         print the experiment CSV row instead of the state (the
                      parallel row, nbody-par.c:956, on more than one rank)
    --measure-comm    with --run-xps on several ranks: time the step's
                      collectives alone (utils/timing.measure_comm_fraction)
                      for COMMTIME and RATIO
    --xps-precise     COMMTIME and RATIO to 6 decimals
    --checkpoint=PATH save the final state and its step count: PATH ending in
                      .npz is the exact host snapshot in the JAX package's
                      layout (either package resumes the other's); any other
                      PATH is a directory that every rank writes its own
                      shard into (torch.distributed.checkpoint)
    --resume=PATH     restore a .npz or a checkpoint directory and continue
                      to ``steps``; a directory whose padded length is this
                      run's loads each rank's shard straight into place
    --check-nans      check the state after every step (a host read per
                      step: debug mode) and validate it after the run
    --trace=DIR       wrap the timed loop in a torch.profiler trace written
                      under DIR (rank 0), and report its collective share
    --chunk-steps=K   with frames, cap the steps between two looks at the
                      frame clock; without frames it changes nothing (each
                      step is already its own sequence of launches)
    --openmp          accepted for the reference's argv (no effect)

``secs_per_update > 0`` renders a frame into the PPM whenever that many
seconds of wall clock have passed (the reference's display+msync);
``NBODY_FRAME_LOG=FILE`` appends one line per frame to FILE.  On one
device with ``--pallas`` and N above ``NBODY_HUGE_THRESHOLD`` (default
2000000, the JAX CLI's) no step is discarded to warm up or to probe the
frame cadence, and the frame clock is read after every step.  A run over
ranks that this command spawned draws frames on rank 0 from the gathered
state; under an external launcher no frames are drawn, as the reference's
parallel binary draws none.

Ranks: one rank is one process with one device.  Outside a launcher
``--devices=K`` (or ``--mesh2d``) spawns K ranks from this command
(``parallel.multihost.spawn``), and rank 0's output is this command's.
Under torchrun, or the JAX package's manual spelling (``COORDINATOR_ADDRESS``,
``NBODY_NUM_PROCESSES``, ``NBODY_PROCESS_ID``), every rank runs this CLI,
joins the group it finds, and ``--devices`` must equal its world size.
Only rank 0 writes the state, the CSV row and the timing lines.

The device comes from ``NBODY_PLATFORM=cpu|cuda``; unset, it is cuda.  The
CLI runs on the CPU only under ``NBODY_PLATFORM=cpu``: without a CUDA device
any other setting exits 1, and so does a mesh of more ranks than cards
(NCCL takes one rank per card).

Behavioral contract preserved exactly:
  - positional args parsed with C atoi/atol semantics (non-numeric -> 0)
  - bodyCt clamped to [2, 10000] with the reference's stderr messages
  - arena dims parsed from the P6 header
  - stderr: "Running N-body with %i bodies and %i steps"
  - stdout: final state (%10.3f x 6) or, under --run-xps, the CSV row
  - stderr: "\\nN-body took: %.3f seconds" + "Performance N-body: %.2f GFLOPS"
"""

from __future__ import annotations

import hashlib
import os
import re
import sys
import time
import zipfile

import numpy as np

from .config import MAXBODIES


def _fail_usage(prog: str) -> None:
    sys.stderr.write(
        "Usage: %s num_bodies secs_per_update ppm_output_file steps "
        "[--run-xps]\n" % prog)
    sys.exit(1)


def _atoi(s: str) -> int:
    """C atoi/atol semantics for the positional args (nbody-seq.c:421,430,
    435): skip leading whitespace, take an optional sign and any leading
    digits, stop at the first non-digit; no digits at all -> 0."""
    digits = re.match(r"\s*([+-]?\d*)", s).group(1)
    if digits in ("", "+", "-"):
        return 0
    return int(digits)


def cadence_chunk_cap(secsup: float, per_step: float) -> int:
    """Largest power-of-two steps-per-chunk that keeps the wall-clock frame
    check running at least about every ``secsup`` seconds.

    The reference checks elapsed time EVERY step (nbody-seq.c:467-471); the
    chunked loop checks between chunks, so a frame could lag by one chunk's
    wall-time.  Capping the chunk at ~secsup worth of steps bounds that lag
    to ~secsup (frames at most ~2*secsup apart).
    """
    cap = int(secsup / max(per_step, 1e-9))
    if cap <= 1:
        return 1
    return 1 << (cap.bit_length() - 1)


def parse_args(argv):
    """The JAX CLI's parser: returns (n, secsup, ppm_path, steps, opts)
    or exits 1 with its messages."""
    if len(argv) < 5:
        _fail_usage(argv[0])
    opts = {
        "run_xps": False, "openmp": False, "measure_comm": False,
        "devices": None, "comm": "allgather", "fast": False, "pallas": False,
        "dtype": None, "no_clamp": False, "checkpoint": None, "resume": None,
        "check_nans": False, "mesh2d": None, "chunk_steps": None,
        "xps_precise": False, "accum": "plain", "trace": None,
    }
    for a in argv[5:]:
        if a == "--run-xps":
            opts["run_xps"] = True
        elif a == "--openmp":
            opts["openmp"] = True
        elif a == "--measure-comm":
            opts["measure_comm"] = True
        elif a.startswith("--devices="):
            try:
                opts["devices"] = int(a.split("=", 1)[1])
                if opts["devices"] < 1:
                    raise ValueError
            except ValueError:
                sys.stderr.write("Bad --devices value (expected an "
                                 "integer >= 1): %s\n" % a)
                sys.exit(1)
        elif a.startswith("--comm="):
            opts["comm"] = a.split("=", 1)[1]
            if opts["comm"] not in ("allgather", "ring"):
                sys.stderr.write("Bad --comm value (expected allgather or "
                                 "ring): %s\n" % a)
                sys.exit(1)
        elif a.startswith("--mesh2d="):
            try:
                pr, pc = a.split("=", 1)[1].lower().split("x")
                opts["mesh2d"] = (int(pr), int(pc))
                if opts["mesh2d"][0] < 1 or opts["mesh2d"][1] < 1:
                    raise ValueError
            except ValueError:
                sys.stderr.write("Bad --mesh2d value (expected RxC, e.g. "
                                 "--mesh2d=2x4): %s\n" % a)
                sys.exit(1)
        elif a == "--fast":
            opts["fast"] = True
        elif a == "--pallas":
            opts["fast"] = True
            opts["pallas"] = True
        elif a == "--trig":
            opts["trig"] = True
        elif a.startswith("--dtype="):
            opts["dtype"] = a.split("=", 1)[1]
            if opts["dtype"] == "float16":
                # The reference mass law mass = radius^3 (nbody-seq.c:
                # 444-447) exceeds float16's 65504 max for any N >= 8 at the
                # default arena: a float16 run can only print NaNs.
                sys.stderr.write(
                    "--dtype=float16 is unsupported: the reference mass "
                    "law (mass = radius^3) overflows float16's 65504 max, "
                    "so every step would be NaN. Use --dtype=bfloat16 for "
                    "16-bit runs (see docs/DESIGN.md, dtype support "
                    "matrix).\n")
                sys.exit(1)
            if opts["dtype"] not in ("bfloat16", "float32", "float64"):
                sys.stderr.write("Bad --dtype value (expected bfloat16, "
                                 "float32 or float64): %s\n" % a)
                sys.exit(1)
        elif a.startswith("--accum="):
            opts["accum"] = a.split("=", 1)[1]
            if opts["accum"] not in ("plain", "compensated"):
                sys.stderr.write("Bad --accum value (expected plain or "
                                 "compensated): %s\n" % a)
                sys.exit(1)
        elif a.startswith("--chunk-steps="):
            try:
                opts["chunk_steps"] = int(a.split("=", 1)[1])
                if opts["chunk_steps"] < 1:
                    raise ValueError
            except ValueError:
                sys.stderr.write("Bad --chunk-steps value (expected an "
                                 "integer >= 1): %s\n" % a)
                sys.exit(1)
        elif a.startswith("--trace="):
            opts["trace"] = a.split("=", 1)[1]
            if not opts["trace"]:
                sys.stderr.write("Bad --trace value (expected a directory "
                                 "path): %s\n" % a)
                sys.exit(1)
        elif a == "--xps-precise":
            opts["xps_precise"] = True
        elif a == "--no-clamp":
            opts["no_clamp"] = True
        elif a == "--check-nans":
            opts["check_nans"] = True
        elif a.startswith("--checkpoint="):
            opts["checkpoint"] = a.split("=", 1)[1]
        elif a.startswith("--resume="):
            opts["resume"] = a.split("=", 1)[1]
        else:
            sys.stderr.write("Unknown flag: %s\n" % a)
            sys.exit(1)
    # --trig, the one flag the JAX CLI lacks, is a key of opts only when
    # given, so every other argv parses to the JAX parser's opts.
    if opts.get("trig") and not opts["pallas"]:
        sys.stderr.write("--trig selects the parity pass of --pallas; "
                         "without --pallas the trig path is the default\n")
        sys.exit(1)
    if opts.get("trig") and opts["dtype"] not in (None, "float64"):
        sys.stderr.write("--pallas --trig computes in float64 only: "
                         "--dtype=%s\n" % opts["dtype"])
        sys.exit(1)
    n = _atoi(argv[1])
    if not opts["no_clamp"]:
        if n > MAXBODIES:
            sys.stderr.write("Using only %d bodies...\n" % MAXBODIES)
            n = MAXBODIES
        elif n < 2:
            sys.stderr.write("Using two bodies...\n")
            n = 2
    secsup = _atoi(argv[2])
    ppm_path = argv[3]
    steps = _atoi(argv[4])
    return n, secsup, ppm_path, steps, opts


def _device(torch):
    """The run's device from NBODY_PLATFORM, or None after reporting why it
    is unusable."""
    requested = os.environ.get("NBODY_PLATFORM") or "cuda"
    if requested not in ("cpu", "cuda"):
        sys.stderr.write("Bad NBODY_PLATFORM value (expected cpu or cuda): "
                         "%s\n" % requested)
        return None
    if requested == "cuda" and not torch.cuda.is_available():
        sys.stderr.write("no CUDA device is available (the device is cuda "
                         "unless NBODY_PLATFORM=cpu)\n")
        return None
    return torch.device(requested)


def _log_frame(path: str, frame: np.ndarray) -> None:
    """One line of frame accounting in the JAX CLI's format: pixel and tint
    counts and a content hash, so a recorded run's log backs any claim made
    about the rendered frame."""
    px = frame.reshape(-1, 3)
    lit = px[(px != 0).any(axis=1)].astype(np.uint32)
    # Distinct colours among the lit pixels, counted through a table of all
    # 2**24 of them (sorting the pixels, as np.unique does, takes most of a
    # second per frame at 1024x768).
    seen = np.zeros(1 << 24, np.bool_)
    seen[(lit[:, 0] << 16) | (lit[:, 1] << 8) | lit[:, 2]] = True
    with open(path, "a") as f:
        f.write("frame %.3f nonzero=%d tints=%d md5=%s\n"
                % (time.time(), lit.shape[0], np.count_nonzero(seen),
                   hashlib.md5(px.tobytes()).hexdigest()))


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    n, secsup, ppm_path, steps, opts = parse_args(argv)

    import torch

    from .parallel import multihost
    from .utils import ppm as ppmio

    launched = multihost.running_under_pod_launcher()
    rank, world = multihost.launcher_ranks() if launched else (0, 1)
    rank0 = rank == 0
    device = _device(torch)
    if device is None:
        return 1
    if opts["dtype"] is None:
        parity = device.type == "cpu" or opts.get("trig")
        opts["dtype"] = "float64" if parity else "float32"

    try:
        ppmio.read_header(ppm_path)
    except (OSError, ppmio.PPMError) as e:
        sys.stderr.write("Cannot read %s: %s\n" % (ppm_path, e))
        return 1

    if rank0:
        sys.stderr.write("Running N-body with %i bodies and %i steps\n"
                         % (n, steps))

    if opts["mesh2d"]:
        n_dev = opts["mesh2d"][0] * opts["mesh2d"][1]
        if opts["devices"] not in (None, n_dev):
            sys.stderr.write(
                "--mesh2d=%dx%d implies %d devices; conflicting "
                "--devices=%d\n" % (opts["mesh2d"][0], opts["mesh2d"][1],
                                    n_dev, opts["devices"]))
            return 1
        if n_dev == 1 and rank0:
            sys.stderr.write("Note: --mesh2d=1x1 is a single-device run "
                             "(no 2-D decomposition)\n")
    else:
        # One device, or under a launcher every rank it started (the JAX
        # CLI's len(jax.devices())).
        n_dev = opts["devices"] or world
    if opts.get("trig") and n_dev > 1:
        if rank0:
            sys.stderr.write("--pallas --trig runs on one device (%d "
                             "requested)\n" % n_dev)
        return 1
    args = (n, secsup, ppm_path, steps, opts, n_dev)
    if launched and n_dev != world:
        if rank0:
            sys.stderr.write("%d devices requested, but the launcher started "
                             "%d ranks (one rank is one device)\n"
                             % (n_dev, world))
        return 1
    if n_dev == 1:
        return _simulate(device, *args, spawned=False)
    if launched:
        import torch.distributed as dist
        try:
            device = multihost.initialize(device.type)
        except (RuntimeError, ValueError) as e:
            sys.stderr.write("multihost init failed: %s\n" % e)
            return 1
        try:
            return _simulate(device, *args, spawned=False)
        finally:
            dist.destroy_process_group()
    if device.type == "cuda":
        # Every rank needs a card of its own: NCCL refuses two ranks on one.
        from .parallel.mesh import check_mesh_fits
        try:
            check_mesh_fits(opts["mesh2d"] or (n_dev,),
                            torch.cuda.device_count(), "cuda")
        except ValueError as e:
            sys.stderr.write("%s\n" % e)
            return 1
    # One command, one result: spawn the ranks here, each with its share of
    # this process's threads.
    return multihost.spawn(_simulate, n_dev, device.type,
                           args=args + (True,),
                           threads=max(1, torch.get_num_threads() // n_dev))


def _from_rank0(value: int, device) -> int:
    """Rank 0's ``value`` on every rank (a broadcast), so that decisions
    made from one rank's clock keep the ranks' collectives in step."""
    import torch
    import torch.distributed as dist
    t = torch.tensor([value], dtype=torch.int64, device=device)
    dist.broadcast(t, 0)
    return int(t.item())


def _simulate(device, n, secsup, ppm_path, steps, opts, n_dev,
              spawned) -> int:
    """The run on this process's device: the single-device run, or one rank
    of an ``n_dev``-rank run in a process group that exists already (every
    rank calls it; only rank 0 reports, as in nbody-par.c:939-959).
    ``spawned``: the ranks were started by one command, which draws frames
    from the gathered state as a single-process run does (the reference's
    parallel binary, like an externally launched run, draws none)."""
    import torch

    from .config import SimConfig
    from .models.engine import run, step
    from .parallel import multihost
    from .state import init_state, pad_state, unpad_state
    from .utils import checkpoint as ckpt
    from .utils import ppm as ppmio
    from .utils.output import format_state, nr_flops, xps_csv_par, xps_csv_seq

    multi = n_dev > 1
    ppm = ppmio.read_header(ppm_path)
    cfg = SimConfig(
        xdim=ppm.xdim, ydim=ppm.ydim,
        force_mode=("trig" if opts.get("trig") or not opts["fast"]
                    else "fast"),
        dtype=opts["dtype"],
        kernel="cuda" if opts["pallas"] else "dense",
        accum=opts["accum"])

    rank0, mesh = True, None
    host = device  # where the full state is built or restored
    if multi:
        import torch.distributed as dist

        from .parallel.mesh import (gather_state, make_mesh, settle,
                                    shard_state)
        rank0 = dist.get_rank() == 0
        host = torch.device("cpu")
        if opts["mesh2d"]:
            from .parallel.grid2d import make_grid2d_run, make_mesh2d
            mesh = make_mesh2d(*opts["mesh2d"], device.type)
        else:
            from .parallel.sharded_step import make_sharded_run
            mesh = make_mesh(n_dev, device.type)
    # The kernels' 128-row blocks need tile-aligned shards.
    pad_mult = n_dev * (128 if opts["pallas"] else 1)

    # --resume: a directory is the sharded checkpoint, a file the .npz.  A
    # directory whose padded length is this run's loads each rank's shard
    # straight into place, on either mesh shape; any other loads whole.
    start_step = 0
    pre_sharded = False
    if opts["resume"]:
        try:
            if os.path.isdir(opts["resume"]):
                meta = ckpt.dcp_metadata(opts["resume"])
                target = None
                if multi and ckpt.dcp_saved_length(opts["resume"], meta) \
                        == n + ((-n) % pad_mult):
                    target = mesh
                state, start_step, n_ck = ckpt.load_state_dcp(
                    opts["resume"], device if target else host,
                    cfg.torch_dtype, mesh=target, meta=meta)
                if target is not None:
                    n_real, pre_sharded = n_ck, True
                else:
                    state = unpad_state(state, n_ck)
            else:
                state, start_step = ckpt.load_state(opts["resume"], host,
                                                    cfg.torch_dtype)
                n_ck = state.n
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as e:
            # EOFError / BadZipFile: numpy's npz loader raises these (not
            # OSError) for truncated or corrupted archives.
            if rank0:
                sys.stderr.write("Cannot resume from %s: %s\n"
                                 % (opts["resume"], e))
            return 1
        if n_ck != n:
            if rank0:
                sys.stderr.write("Checkpoint has %d bodies, expected %d\n"
                                 % (n_ck, n))
            return 1
    else:
        state = init_state(n, cfg, device=host)
    remaining = max(0, steps - start_step)

    if multi and not pre_sharded:
        state, n_real = pad_state(state, pad_mult)
        state = shard_state(state, mesh, device)
    elif not multi:
        n_real = n

    # Huge single-device runs (the JAX CLI's threshold, which tests lower to
    # drive this branch at small N): a step costs a whole force pass, so no
    # step is discarded to warm up or to probe the frame cadence.  The step
    # is engine.step's at any N: its force pass runs in row launches that
    # bound its workspace (ops.cuda_step.symmetric_forces, or
    # streamed_forces for K2).
    huge_threshold = int(os.environ.get("NBODY_HUGE_THRESHOLD", 2_000_000))
    huge = not multi and opts["pallas"] and n > huge_threshold
    if not multi:
        def advance(st, k, nan_check_from=None):
            return run(cfg, st, k, nan_check_from)

        def one_step(st):
            return step(cfg, st)
    else:
        def advance(st, k, nan_check_from=None):
            runner = (make_grid2d_run(cfg, mesh, k) if opts["mesh2d"]
                      else make_sharded_run(cfg, mesh, k, opts["comm"]))
            return runner(st, nan_check_from)

        def one_step(st):
            return advance(st, 1)

    def fence():
        # Nothing in the run loops waits for the device: a host clock read
        # means completed work only after this.
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if device.type == "cuda" and remaining > 0:
        if huge:
            # The kernels are only built, as the JAX CLI only compiles.
            from .ops import _build
            _build.load("kernels")
        else:
            # One discarded step outside the timed region: it builds the
            # CUDA kernels (nvcc, at first use), launches the step's one,
            # and warms the sort and elementwise kernels — the counterpart
            # of the JAX CLI's AOT compile, so no build lands inside RTIME.
            one_step(state)
            fence()

    render_fn = None
    if secsup > 0 and (spawned or not multi):
        from .ops.render import render_frame
        from .utils.timing import span

        # Optional frame accounting for tests/instrumentation: append one
        # line per rendered frame to the named file.
        frame_log = os.environ.get("NBODY_FRAME_LOG")

        def render_fn(st):
            if multi:
                st = unpad_state(gather_state(st), n_real)  # every rank
                if not rank0:
                    return
            pixels = render_frame(cfg, st.x, st.y, st.radius, n)
            with span("nbody.frame.copy"):
                frame = pixels.cpu().numpy()
            with span("nbody.frame.write"):
                ppmio.write_pixels(ppm, frame)
            if frame_log:
                _log_frame(frame_log, frame)

    comm_time_per_step = 0.0
    if opts["measure_comm"] and opts["run_xps"] and multi:
        from .utils.timing import measure_comm_fraction
        comm_time_per_step = measure_comm_fraction(
            cfg, mesh, state, "grid2d" if opts["mesh2d"] else opts["comm"])

    # With frames the loop runs in chunks and looks at the clock between
    # them.  Without frames --chunk-steps changes nothing: the run loops are
    # already one sequence of launches per step, queued without a fence.
    chunk = max(1, min(1000, remaining // 20 or 1))
    if opts["chunk_steps"]:
        chunk = min(chunk, opts["chunk_steps"])
    if huge:
        # A huge step takes seconds to minutes: look at the frame clock
        # after every step, and run no cadence probe.
        chunk = 1
    if render_fn is not None and remaining > 0 and chunk > 1:
        # Frame-cadence fidelity (reference: the elapsed check runs EVERY
        # step, nbody-seq.c:467-471): time one step on a discarded copy of
        # the state, outside the timed region (on the card the warm-up step
        # above was its first dispatch), and cap the chunk so the
        # between-chunk check runs at least about every ``secsup`` seconds.
        t_probe = time.time()
        one_step(state)
        fence()
        chunk = min(chunk, cadence_chunk_cap(secsup, time.time() - t_probe))
        if multi:
            chunk = _from_rank0(chunk, device)

    # --trace=DIR: wrap the timed region in a torch.profiler trace and
    # report the trace-derived collective share afterwards.  Profiling
    # overhead lands inside the timed region by nature; use untraced runs
    # for headline timing.
    tracer = None
    if opts["trace"] and rank0:
        from .utils.timing import trace as trace_ctx
        tracer = trace_ctx(opts["trace"])
        try:
            tracer.__enter__()
        except Exception as e:  # unwritable dir etc. — profiling is
            sys.stderr.write(   # auxiliary, never kill the simulation
                "Cannot start trace at %s: %s\n" % (opts["trace"], e))
            tracer = None

    nan_check_from = start_step if opts["check_nans"] else None
    if multi:
        settle(device)
    t0 = time.time()
    try:
        if render_fn is not None and remaining > 0:
            # Wall-clock-driven frame updates (reference main loop,
            # nbody-seq.c:457-472).
            lastup = 0.0
            done = 0
            while done < remaining:
                k = min(chunk, remaining - done)
                state = advance(state, k, nan_check_from)
                done += k
                if nan_check_from is not None:
                    nan_check_from += k
                # Completion fence BEFORE the elapsed check: launches are
                # async, so without it the loop queues every chunk in
                # milliseconds and the wall-clock test fires at most once —
                # the reference's cadence (nbody-seq.c:467-471) is measured
                # against completed simulation work.
                fence()
                due = time.time() - lastup > secsup
                if multi:
                    due = bool(_from_rank0(int(due), device))
                if due:
                    render_fn(state)
                    lastup = time.time()
        else:
            state = advance(state, remaining, nan_check_from)
        fence()
        if multi:
            settle(device)
    except BaseException:
        # A failure mid-run (NaN under --check-nans, device error, Ctrl-C)
        # must still finalize the trace — it is exactly the profile the
        # user wants for debugging the failure.
        if tracer is not None:
            try:
                tracer.__exit__(None, None, None)
            except Exception:
                pass
        raise
    rtime = time.time() - t0
    if tracer is not None:
        try:
            tracer.__exit__(None, None, None)
        except Exception as e:  # a failing export (disk full, ...) must
            sys.stderr.write(   # not discard the completed simulation
                "Cannot finish trace at %s: %s\n" % (opts["trace"], e))
        else:
            try:
                from .utils.timing import trace_comm_share
                ts = trace_comm_share(opts["trace"])
                sys.stderr.write(
                    "Trace: op time %.3f s, collectives %.3f s (%.2f%% "
                    "share) -> %s\n" % (ts["op_us"] / 1e6,
                                        ts["collective_us"] / 1e6,
                                        100.0 * ts["share"], opts["trace"]))
            except Exception as e:  # a missing/odd trace must not kill it
                sys.stderr.write("Trace written to %s (share extraction "
                                 "failed: %s)\n" % (opts["trace"], e))
    comm_time = comm_time_per_step * remaining

    # Throughput accounting covers only the steps actually executed (with
    # --resume that is fewer than ``steps``; a negative count runs none).
    flops = nr_flops(n, remaining)
    gflops = flops / 1e9 / rtime if rtime > 0 else float("nan")

    # The state's true step count: with --resume past the argv target
    # (start_step > steps) no steps run, and recording argv's ``steps``
    # would silently rewind the counter without rewinding the state.
    done_steps = start_step + remaining
    # A directory checkpoint is written from the still-sharded state, each
    # rank its own shard (a collective); the .npz from the gathered state.
    ckpt_dir = opts["checkpoint"] and not opts["checkpoint"].endswith(".npz")
    if ckpt_dir:
        try:
            ckpt.save_state_dcp(opts["checkpoint"], state, done_steps,
                                n_real, mesh)
        except Exception as e:  # noqa: BLE001 — as the JAX CLI's guard:
            # report, and still deliver the run's output.
            if rank0:
                sys.stderr.write("Cannot checkpoint to %s: %s\n"
                                 % (opts["checkpoint"], e))

    if multi:
        state = unpad_state(gather_state(state), n_real)

    if opts["checkpoint"] and not ckpt_dir and rank0:
        try:
            ckpt.save_state(opts["checkpoint"], state, done_steps)
        except OSError as e:
            # A failed save (e.g. a missing parent directory) must not crash
            # the run into a traceback after the whole simulation ran —
            # report it and still deliver the run's output below.  Only
            # OSError, as in the JAX CLI.
            sys.stderr.write("Cannot checkpoint to %s: %s\n"
                             % (opts["checkpoint"], e))

    if opts["check_nans"]:
        from .utils.debug import validate_state
        diag = validate_state(state, cfg.xdim, cfg.ydim)
        if not diag.ok():
            if rank0:
                sys.stderr.write("State validation FAILED: NaNs in %s\n"
                                 % ",".join(diag.nan_fields))
            return 1
        if rank0:
            sys.stderr.write(
                "State validation ok: max|v|=%.3g max|f|=%.3g in_bounds=%s\n"
                % (diag.max_speed, diag.max_force, diag.pos_in_bounds))

    # SIZE,NODES,CPUS_PER_NODE: devices, hosts, devices per host.
    nodes = multihost.topology()["hosts"] if multi and opts["run_xps"] else 1
    if rank0:
        if not opts["run_xps"]:
            sys.stdout.write(format_state(state))
        elif multi:
            sys.stdout.write(xps_csv_par(n_dev, nodes, n_dev // nodes, n,
                                         rtime, comm_time, gflops,
                                         precise=opts["xps_precise"]) + "\n")
        else:
            sys.stdout.write(xps_csv_seq(n, rtime, gflops) + "\n")
        sys.stderr.write("\nN-body took: %.3f seconds\n" % rtime)
        sys.stderr.write("Performance N-body: %.2f GFLOPS\n" % gflops)
    return 0

if __name__ == "__main__":
    sys.exit(main())
