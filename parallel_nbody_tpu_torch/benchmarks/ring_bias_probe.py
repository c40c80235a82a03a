"""What the coincident-pair bias costs at ring block shapes.

The counterpart of the JAX package's ``benchmarks/ring_bias_probe.py``
(``:46-85``): the biased and the unbiased variant of the kernel a ring
step runs, on one card, at

  - ``1M_square_streamed``: 1048576 x 1048576 through K2
    (``block_forces_streamed``), one rank's ring shape at N=1M;
  - ``128K_block_streamed``: 131072 x 131072 through K2, the block of one
    ring hop of an 8-rank run at N=1M;
  - ``64K_square_resident``: 65536 x 65536 through K1 (``block_forces``).

Inputs are ``random_state`` from a ``torch.Generator`` seeded with 0 (no
coincident pair, so both variants compute the same forces but for the
bias's rounding).  Each variant's time is the best of ``reps`` calls after
a warm-up call, by CUDA events; ``bias_cost_pct`` is biased over unbiased.

    python -m parallel_nbody_tpu_torch.benchmarks.ring_bias_probe \\
        [--device=cpu] [--out=PATH]

prints the record as JSON and writes it to PATH (on the card by default
``benchmarks/ring_bias.json`` beside this module).  Without a card it
exits 1; ``--device=cpu`` runs the plain versions at ``CPU_CASES``.
"""

from __future__ import annotations

import json
import sys

import torch

from ..config import SimConfig
from ..ops.cuda_step import block_forces, block_forces_streamed
from ..state import random_state
from ..utils.device import tool_argv
from ._tools import best_seconds, fingerprint, record_path, write_record

SEED = 0
# (label, rows, columns, kernel wrapper name, reps on the card)
CASES = (("1M_square_streamed", 1 << 20, 1 << 20, "block_forces_streamed",
          3),
         ("128K_block_streamed", 1 << 17, 1 << 17, "block_forces_streamed",
          5),
         ("64K_square_resident", 1 << 16, 1 << 16, "block_forces", 5))
CPU_CASES = (("1K_square_streamed", 1024, 1024, "block_forces_streamed", 1),
             ("512_square_resident", 512, 512, "block_forces", 1))
_KERNELS = {"block_forces": block_forces,
            "block_forces_streamed": block_forces_streamed}


def time_case(device, n_rows, n_cols, kernel, reps) -> dict:
    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
    gen = torch.Generator(device=device).manual_seed(SEED)
    st = random_state(max(n_rows, n_cols), cfg, gen, device=device)
    rows = [t[:n_rows] for t in (st.x, st.y, st.mass, st.radius)]
    cols = [t[:n_cols] for t in (st.x, st.y, st.mass, st.radius)]
    fn = _KERNELS[kernel]
    res = {}
    for biased in (True, False):
        seconds = best_seconds(
            lambda: fn(cfg, *rows, *cols, row_g0=0, col_g0=0,
                       biased=biased), device, reps)
        pairs = float(n_rows) * n_cols
        res["biased" if biased else "unbiased"] = {
            "s": seconds, "pairs_per_s": pairs / seconds}
    res["bias_cost_pct"] = 100.0 * (res["biased"]["s"]
                                    / res["unbiased"]["s"] - 1.0)
    res.update(rows=n_rows, cols=n_cols, kernel=kernel, reps=reps)
    return res


def probe(device, reps: int | None = None, log=print) -> dict:
    out = {"cases": {}}
    for label, n_rows, n_cols, kernel, case_reps in (
            CASES if device.type == "cuda" else CPU_CASES):
        res = time_case(device, n_rows, n_cols, kernel, reps or case_reps)
        out["cases"][label] = res
        log("%s %s" % (label, json.dumps(res)))
    out["fingerprint"] = fingerprint(device)
    return out


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    got = tool_argv("ring_bias_probe", argv, ("device", "out"))
    if got is None:
        return 1
    _, flags, device = got
    out = probe(device, log=lambda s: print(s, flush=True))
    print(json.dumps(out))
    write_record(out, record_path(flags, device, "ring_bias.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
