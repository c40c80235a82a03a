"""Command-line interface with the reference's argv contract.

Reference CLI (nbody-seq.c:386-499):

    num_bodies secs_per_update ppm_output_file steps [--run-xps]

plus the JAX package's extensions, parsed the same way (cli.py of
``parallel_nbody_tpu``).  It runs one single-device simulation:

    --fast            transcendental-free force path
    --pallas          the hand-written CUDA force kernels (implies --fast;
                      the flag keeps the JAX package's name): K1, or K2
                      above 131072 bodies.  On a CPU device the kernels'
                      plain PyTorch versions run.
    --dtype=T         bfloat16 | float32 | float64 (default: float64 on
                      cpu, float32 on cuda)
    --no-clamp        allow N > 10000 (the reference clamps to MAXBODIES)
    --accum=A         plain | compensated (Kahan folds in the kernels'
                      partial sums; the dense path ignores it)
    --run-xps         print the experiment CSV row instead of the state
    --checkpoint=PATH save the final state and its step count; PATH must
                      end in .npz (the exact host snapshot, in the JAX
                      package's layout: either package resumes the other's)
    --resume=PATH     restore a .npz snapshot and continue to ``steps``
    --check-nans      check the state after every step (a host read per
                      step: debug mode) and validate it after the run
    --trace=DIR       wrap the timed loop in a torch.profiler trace written
                      under DIR, and report its collective share
    --chunk-steps=K   with frames, cap the steps between two looks at the
                      frame clock; without frames it changes nothing (each
                      step is already its own sequence of launches)
    --openmp, --measure-comm, --xps-precise, --devices=1, --comm=MODE,
    --mesh2d=1x1      accepted with the JAX CLI's single-device meaning
                      (no effect on one device)

``secs_per_update > 0`` renders a frame into the PPM whenever that many
seconds of wall clock have passed (the reference's display+msync);
``NBODY_FRAME_LOG=FILE`` appends one line per frame to FILE.

Not yet ported; each exits 1 naming the flag: --devices=K>1, --mesh2d with
more than one device, and --checkpoint= / --resume= of a directory (the
sharded checkpoint).

The device comes from ``NBODY_PLATFORM=cpu|cuda``; unset, it is cuda.  The
CLI runs on the CPU only under ``NBODY_PLATFORM=cpu``: without a CUDA device
any other setting exits 1.

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


def _unported(opts, n_dev: int) -> str | None:
    """The first requested feature this CLI does not run yet, or None."""
    checks = [
        (n_dev > 1 and opts["mesh2d"] is None,
         "--devices=%s" % opts["devices"]),
        (n_dev > 1, "--mesh2d with more than one device"),
        (opts["checkpoint"] is not None
         and not opts["checkpoint"].endswith(".npz"),
         "--checkpoint to a path that does not end in .npz (the sharded "
         "checkpoint directory)"),
        (opts["resume"] is not None and os.path.isdir(opts["resume"]),
         "--resume from a directory (the sharded checkpoint)"),
    ]
    for requested, name in checks:
        if requested:
            return name
    return None


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

    from .config import SimConfig
    from .models.engine import run, step
    from .state import init_state
    from .utils import checkpoint as ckpt
    from .utils import ppm as ppmio
    from .utils.output import format_state, nr_flops, xps_csv_seq

    device = _device(torch)
    if device is None:
        return 1
    if opts["dtype"] is None:
        opts["dtype"] = "float64" if device.type == "cpu" else "float32"

    try:
        ppm = ppmio.read_header(ppm_path)
    except (OSError, ppmio.PPMError) as e:
        sys.stderr.write("Cannot read %s: %s\n" % (ppm_path, e))
        return 1

    cfg = SimConfig(
        xdim=ppm.xdim, ydim=ppm.ydim,
        force_mode="fast" if opts["fast"] else "trig",
        dtype=opts["dtype"],
        kernel="cuda" if opts["pallas"] else "dense",
        accum=opts["accum"])

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
        if n_dev == 1:
            sys.stderr.write("Note: --mesh2d=1x1 is a single-device run "
                             "(no 2-D decomposition)\n")
    else:
        n_dev = opts["devices"] or 1
    # On one device --comm=ring has nothing to stream: ignored, as in the
    # JAX CLI.
    missing = _unported(opts, n_dev)
    if missing is not None:
        sys.stderr.write("%s is not yet ported to parallel_nbody_tpu_torch\n"
                         % missing)
        return 1

    start_step = 0
    if opts["resume"]:
        try:
            state, start_step = ckpt.load_state(opts["resume"], device,
                                                cfg.torch_dtype)
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as e:
            # EOFError / BadZipFile: numpy's npz loader raises these (not
            # OSError) for truncated or corrupted archives.
            sys.stderr.write("Cannot resume from %s: %s\n"
                             % (opts["resume"], e))
            return 1
        if state.n != n:
            sys.stderr.write("Checkpoint has %d bodies, expected %d\n"
                             % (state.n, n))
            return 1
    else:
        state = init_state(n, cfg, device=device)
    remaining = max(0, steps - start_step)

    def fence():
        # Nothing in engine.run waits for the device: a host clock read
        # means completed work only after this.
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if device.type == "cuda" and remaining > 0:
        # One discarded step outside the timed region: it builds the CUDA
        # kernels (nvcc, at first use), launches the step's one, and warms the
        # sort and elementwise kernels — the counterpart of the JAX CLI's
        # AOT compile, so no build lands inside RTIME.
        step(cfg, state)
        fence()

    render_fn = None
    if secsup > 0:
        from .ops.render import render_frame

        # Optional frame accounting for tests/instrumentation: append one
        # line per rendered frame to the named file.
        frame_log = os.environ.get("NBODY_FRAME_LOG")

        def render_fn(st):
            frame = render_frame(cfg, st.x, st.y, st.radius, n).cpu().numpy()
            ppmio.write_pixels(ppm, frame)
            if frame_log:
                _log_frame(frame_log, frame)

    # With frames the loop runs in chunks and looks at the clock between
    # them.  Without frames --chunk-steps changes nothing: engine.run is
    # already one sequence of launches per step, queued without a fence.
    chunk = max(1, min(1000, remaining // 20 or 1))
    if opts["chunk_steps"]:
        chunk = min(chunk, opts["chunk_steps"])
    if render_fn is not None and remaining > 0 and chunk > 1:
        # Frame-cadence fidelity (reference: the elapsed check runs EVERY
        # step, nbody-seq.c:467-471): time one step on a discarded copy of
        # the state, outside the timed region (on the card the warm-up step
        # above was its first dispatch), and cap the chunk so the
        # between-chunk check runs at least about every ``secsup`` seconds.
        t_probe = time.time()
        step(cfg, state)
        fence()
        chunk = min(chunk, cadence_chunk_cap(secsup, time.time() - t_probe))

    # --trace=DIR: wrap the timed region in a torch.profiler trace and
    # report the trace-derived collective share afterwards.  Profiling
    # overhead lands inside the timed region by nature; use untraced runs
    # for headline timing.
    tracer = None
    if opts["trace"]:
        from .utils.timing import trace as trace_ctx
        tracer = trace_ctx(opts["trace"])
        try:
            tracer.__enter__()
        except Exception as e:  # unwritable dir etc. — profiling is
            sys.stderr.write(   # auxiliary, never kill the simulation
                "Cannot start trace at %s: %s\n" % (opts["trace"], e))
            tracer = None

    nan_check_from = start_step if opts["check_nans"] else None
    t0 = time.time()
    try:
        if render_fn is not None and remaining > 0:
            # Wall-clock-driven frame updates (reference main loop,
            # nbody-seq.c:457-472).
            lastup = 0.0
            done = 0
            while done < remaining:
                k = min(chunk, remaining - done)
                state = run(cfg, state, k, nan_check_from)
                done += k
                if nan_check_from is not None:
                    nan_check_from += k
                # Completion fence BEFORE the elapsed check: launches are
                # async, so without it the loop queues every chunk in
                # milliseconds and the wall-clock test fires at most once —
                # the reference's cadence (nbody-seq.c:467-471) is measured
                # against completed simulation work.
                fence()
                if time.time() - lastup > secsup:
                    render_fn(state)
                    lastup = time.time()
        else:
            state = run(cfg, state, remaining, nan_check_from)
        fence()
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

    # Throughput accounting covers only the steps actually executed (with
    # --resume that is fewer than ``steps``; a negative count runs none).
    flops = nr_flops(n, remaining)
    gflops = flops / 1e9 / rtime if rtime > 0 else float("nan")

    if opts["checkpoint"]:
        # The state's true step count: with --resume past the argv target
        # (start_step > steps) no steps run, and recording argv's ``steps``
        # would silently rewind the counter without rewinding the state.
        done_steps = start_step + remaining
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
            sys.stderr.write("State validation FAILED: NaNs in %s\n"
                             % ",".join(diag.nan_fields))
            return 1
        sys.stderr.write(
            "State validation ok: max|v|=%.3g max|f|=%.3g in_bounds=%s\n"
            % (diag.max_speed, diag.max_force, diag.pos_in_bounds))

    if opts["run_xps"]:
        sys.stdout.write(xps_csv_seq(n, rtime, gflops) + "\n")
    else:
        sys.stdout.write(format_state(state))
    sys.stderr.write("\nN-body took: %.3f seconds\n" % rtime)
    sys.stderr.write("Performance N-body: %.2f GFLOPS\n" % gflops)
    return 0


if __name__ == "__main__":
    sys.exit(main())
