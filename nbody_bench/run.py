"""Run one cell of ``BENCHMARK.json`` on the card and print its line.

    python3 -m nbody_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints one JSON object as the last line of standard output, and each number
compared for ``correct`` beside its limit as the last lines of standard
error.  Exits 1 without a result when no CUDA card is visible or fewer than
the cell asks for, when the port cannot be imported, or when JAX or the JAX
package is loaded in this process once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")
# Build and kernel caches at fixed paths inside the checkout, so that only
# a checkout's first run builds.  The port's own kernels build into
# parallel_nbody_tpu_torch/_build/, also inside the checkout.
CACHES = (("TRITON_CACHE_DIR", "triton"),
          ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
          ("CUDA_CACHE_PATH", "cuda"))


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nbody_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in CACHES:
        os.environ[var] = os.path.join(ROOT, ".nbench_cache", sub)

    with open(MANIFEST) as f:
        manifest = json.load(f)
    chips = {w["name"]: w["chips"] for w in manifest["workloads"]}
    if args.workload not in chips:
        sys.stderr.write("no workload %r in BENCHMARK.json\n" % args.workload)
        return 1
    import torch
    t_torch = time.perf_counter()
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < chips[args.workload]:
        sys.stderr.write("needs %d CUDA device(s); torch sees %d\n" % (
            chips[args.workload],
            torch.cuda.device_count() if torch.cuda.is_available() else 0))
        return 1

    t_query = time.perf_counter()
    from . import harness
    t_port = time.perf_counter()
    cell = harness.load_cell(MANIFEST, args.workload)
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_start=T_START)
    # The set-up's imports, split: torch, the card query, the port.
    out["phases"] = dict(import_torch=t_torch - T_START,
                         cuda_query=t_query - t_torch,
                         import_port=t_port - t_query, **out["phases"])
    bad = harness.forbidden_modules()
    if bad:
        sys.stderr.write("loaded in this process: %s\n" % ", ".join(bad))
        return 1
    checks = out["checks"]
    for c in checks.values():
        c["value"] = _finite(c["value"])
    for name, c in checks.items():
        sys.stderr.write("check %s %s limit %s\n"
                         % (name, c["value"], c["limit"]))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
