"""Sweep what the port sets at run time: K2's band, and K1 against K2.

The counterpart of the JAX package's ``benchmarks/autotune.py``, which
sweeps the Pallas kernels' tiles.  The port's tile is a compile-time 128
(``kBlock`` in csrc/pairs.cuh) and is not swept; what a run can set is

  - ``band``: K2's column band (``block_forces_streamed(..., band=)``,
    65536 by default, ``cuda_step.STREAM_BAND``), swept over ``BANDS`` at
    N=262144 and 1048576;
  - the K1/K2 threshold (``cuda_step.STREAMED_ABOVE``, 131072, the TPU's
    VMEM limit): ``block_forces`` against K2 forced at each band of
    ``THRESHOLD_BANDS`` at N in {65536, 131072, 262144}.  On the card
    ``block_forces`` takes the symmetric pass to 131072 bodies
    (``cuda_step.takes_symmetric``) and K1 past it; the row's ``kernel``
    names the one that ran.

Every case is one force pass over the ``random_state`` of N bodies (a
``torch.Generator`` seeded with 0) in fp32, unbiased (the variant a
``random_state`` run takes), the best of ``reps`` passes after a warm-up
pass, by CUDA events.  ``best`` names the fastest case at each N.

    python -m parallel_nbody_tpu_torch.benchmarks.autotune \\
        [--device=cpu] [--out=PATH]

prints the record as JSON and writes it to PATH (on the card by default
``benchmarks/autotune.json`` beside this module).  Without a card it exits
1; ``--device=cpu`` sweeps the plain versions at ``CPU_SWEEP``.
"""

from __future__ import annotations

import json
import sys

import torch

from ..config import SimConfig
from ..ops import cuda_step
from ..ops.cuda_step import (block_forces, block_forces_streamed,
                             takes_symmetric)
from ..state import random_state
from ..utils.device import tool_argv
from ._tools import best_seconds, fingerprint, record_path, write_record

SEED = 0
REPS = 3
BANDS = (16384, 32768, 65536, 131072, 262144)
BAND_SIZES = (262144, 1048576)
THRESHOLD_BANDS = (16384, 32768, 65536)
THRESHOLD_SIZES = (65536, 131072, 262144)
# The CPU's sweep: (band sizes, bands, threshold sizes, threshold bands).
CPU_SWEEP = ((1024,), (256, 512), (512,), (256,))


def _state(n, device):
    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
    gen = torch.Generator(device=device).manual_seed(SEED)
    st = random_state(n, cfg, gen, device=device)
    return cfg, (st.x, st.y, st.mass, st.radius)


def _kernel(device, n, band) -> str:
    """The kernel that ``time_pass`` times."""
    if band is not None:
        return "K2"
    symmetric = (device.type == "cuda" and n <= cuda_step.STREAMED_ABOVE
                 and takes_symmetric(torch.float32, n, n, row_g0=0,
                                     col_g0=0, accum="plain"))
    return "symmetric" if symmetric else "K1"


def time_pass(device, n, band, reps) -> dict:
    """One force pass at N=n: ``block_forces`` (K1, or on the card the
    symmetric pass where it applies) when ``band`` is None, else K2 at
    ``band``."""
    cfg, b = _state(n, device)
    if band is None:
        seconds = best_seconds(lambda: block_forces(cfg, *b, *b,
                                                    biased=False),
                               device, reps)
    else:
        seconds = best_seconds(lambda: block_forces_streamed(
            cfg, *b, *b, band=band, biased=False), device, reps)
    return {"n": n, "kernel": _kernel(device, n, band),
            "band": band, "ms": seconds * 1e3,
            "pairs_per_s": float(n) * n / seconds}


def sweep(device, reps: int = REPS, sizes=None, log=print) -> dict:
    """The band sweep and the threshold sweep; ``sizes`` overrides
    (band sizes, bands, threshold sizes, threshold bands)."""
    if sizes is None:
        sizes = ((BAND_SIZES, BANDS, THRESHOLD_SIZES, THRESHOLD_BANDS)
                 if device.type == "cuda" else CPU_SWEEP)
    band_sizes, bands, threshold_sizes, threshold_bands = sizes
    out = {"band": [], "threshold": []}
    for n in band_sizes:
        for band in bands:
            if band > n:
                continue
            row = time_pass(device, n, band, reps)
            out["band"].append(row)
            log("band N=%d band=%d: %.6f ms, %.6e pairs/s"
                % (n, band, row["ms"], row["pairs_per_s"]))
    for n in threshold_sizes:
        for band in (None,) + tuple(b for b in threshold_bands if b <= n):
            row = time_pass(device, n, band, reps)
            out["threshold"].append(row)
            log("threshold N=%d %s: %.6f ms, %.6e pairs/s"
                % (n, row["kernel"] if band is None
                   else "K2 band=%d" % band,
                   row["ms"], row["pairs_per_s"]))
    best = {}
    for row in out["band"] + out["threshold"]:
        key = str(row["n"])
        if key not in best or row["ms"] < best[key]["ms"]:
            best[key] = row
    out["best"] = best
    out["reps"] = reps
    out["fingerprint"] = fingerprint(device)
    return out


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    got = tool_argv("autotune", argv, ("device", "out"))
    if got is None:
        return 1
    _, flags, device = got
    out = sweep(device, log=lambda s: print(s, flush=True))
    print(json.dumps(out))
    write_record(out, record_path(flags, device, "autotune.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
