"""Does bf16 storage save K2 bandwidth at N=1M?

The counterpart of the JAX package's ``benchmarks/bf16_stream_probe.py``
(``:40-80``): the fp32 and the bf16 force pass at N=1048576 through
``cuda_forces`` (K2, band 65536), from ``random_state`` (a
``torch.Generator`` seeded with 0; the bf16 state is the fp32 one
rounded), in the biased variant that ``pallas_forces`` runs by default.
bf16 is storage only: K2 loads it and upcasts, and computes
and sums in fp32 (csrc/pairs.cuh), so the two passes differ in the bytes
they read, not in the arithmetic.  K2 stages each 128-column tile once per
row block, from L2 or device memory, so on the H100 the force pass is
bound by instruction issue, not by those bytes (PERF.md §5); this probe
measures what halving them buys.  Each mode's time is the best of
``REPS`` passes after a warm-up pass, by CUDA events, and its forces must
be finite.

    python -m parallel_nbody_tpu_torch.benchmarks.bf16_stream_probe \\
        [--device=cpu] [--out=PATH]

prints the record as JSON and writes it to PATH (on the card by default
``benchmarks/bf16_stream_probe.json`` beside this module).  Without a card
it exits 1; ``--device=cpu`` runs the plain versions at N=``CPU_N``.
"""

from __future__ import annotations

import json
import sys

import torch

from ..config import SimConfig
from ..ops.cuda_step import cuda_forces
from ..state import random_state
from ..utils.device import tool_argv
from ._tools import best_seconds, fingerprint, record_path, write_record

N = 1 << 20
CPU_N = 1024
REPS = 3
SEED = 0


def probe(device, n: int | None = None, reps: int = REPS,
          log=print) -> dict:
    n = n or (N if device.type == "cuda" else CPU_N)
    cfg32 = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
    gen = torch.Generator(device=device).manual_seed(SEED)
    st = random_state(n, cfg32, gen, device=device)
    result = {"n": n, "reps": reps, "modes": {}}
    for dtype in ("float32", "bfloat16"):
        cfg = SimConfig(force_mode="fast", dtype=dtype, kernel="cuda")
        b = [t.to(cfg.torch_dtype) for t in (st.x, st.y, st.mass,
                                             st.radius)]
        out = []

        def forces():
            out[:] = cuda_forces(cfg, *b, biased=True)

        seconds = best_seconds(forces, device, reps)
        if not all(bool(torch.isfinite(t).all()) for t in out):
            raise AssertionError("%s force pass at N=%d is not finite"
                                 % (dtype, n))
        result["modes"][dtype] = {"force_pass_s": seconds,
                                  "pairs_per_s": n * (n - 1) / 2 / seconds}
        log("%s: %.6f s (%.6e pairs/s)" % (
            dtype, seconds, result["modes"][dtype]["pairs_per_s"]))
    result["bf16_speedup"] = (result["modes"]["float32"]["force_pass_s"]
                              / result["modes"]["bfloat16"]["force_pass_s"])
    result["fingerprint"] = fingerprint(device)
    return result


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    got = tool_argv("bf16_stream_probe", argv, ("device", "out"))
    if got is None:
        return 1
    _, flags, device = got
    result = probe(device, log=lambda s: print(s, flush=True))
    print(json.dumps(result, indent=2))
    write_record(result, record_path(flags, device, "bf16_stream_probe.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
