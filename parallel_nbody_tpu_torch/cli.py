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
    --openmp, --measure-comm, --xps-precise, --devices=1, --comm=allgather
                      accepted with the JAX CLI's single-device meaning
                      (no effect on one device)
    --chunk-steps=K   accepted: each step is already its own sequence of
                      launches, so the per-dispatch cap always holds

Not yet ported; each exits 1 naming the flag: --devices=K>1, --mesh2d,
--comm=ring, --checkpoint, --resume, --trace, --check-nans, and
secs_per_update > 0 (frame rendering).

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

import os
import re
import sys
import time

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


def _unported(secsup: int, opts) -> str | None:
    """The first requested feature this CLI does not run yet, or None."""
    checks = [
        ((opts["devices"] or 1) > 1, "--devices=%s" % opts["devices"]),
        (opts["mesh2d"] is not None, "--mesh2d"),
        (opts["comm"] == "ring", "--comm=ring"),
        (opts["checkpoint"] is not None, "--checkpoint"),
        (opts["resume"] is not None, "--resume"),
        (opts["trace"] is not None, "--trace"),
        (opts["check_nans"], "--check-nans"),
        (secsup > 0, "secs_per_update > 0 (frame rendering)"),
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


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    n, secsup, ppm_path, steps, opts = parse_args(argv)
    missing = _unported(secsup, opts)
    if missing is not None:
        sys.stderr.write("%s is not yet ported to parallel_nbody_tpu_torch\n"
                         % missing)
        return 1

    import torch

    from .config import SimConfig
    from .models.engine import run, step
    from .state import init_state
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
    state = init_state(n, cfg, device=device)

    if device.type == "cuda":
        # One discarded step outside the timed region: it builds the CUDA
        # kernels (nvcc, at first use), launches the step's one, and warms the
        # sort and elementwise kernels — the counterpart of the JAX CLI's
        # AOT compile, so no build lands inside RTIME.
        if steps > 0:
            step(cfg, state)
        torch.cuda.synchronize(device)

    t0 = time.time()
    state = run(cfg, state, steps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rtime = time.time() - t0

    flops = nr_flops(n, steps)
    gflops = flops / 1e9 / rtime if rtime > 0 else float("nan")
    if opts["run_xps"]:
        sys.stdout.write(xps_csv_seq(n, rtime, gflops) + "\n")
    else:
        sys.stdout.write(format_state(state))
    sys.stderr.write("\nN-body took: %.3f seconds\n" % rtime)
    sys.stderr.write("Performance N-body: %.2f GFLOPS\n" % gflops)
    return 0


if __name__ == "__main__":
    sys.exit(main())
