"""One simulation step at N=10,000,000 on one card (BASELINE config 5's
single-chip scale), and a frame of the result.

The counterpart of the JAX package's ``benchmarks/huge_n.py``: the
``random_state`` of N bodies (a ``torch.Generator`` seeded with 0) in fp32;
one ``engine.step``, which above 131072 bodies runs ``any_coincident`` once
and the force pass through K2 (``block_forces_streamed``, band 65536) as
ONE launch over all N rows and N columns (at N=10M: 153 bands, a
(153, 2, N) fp32 workspace of 12.2 GB), then velocity and position
integration; then ``ops/render.render_frame`` of the new positions,
written as a P6 PPM.
The JAX tool cuts the force pass into host row chunks and renders in
hosted bands because its TPU transport ends any dispatch after about 60 s;
the card has no such limit, so neither cut is made here.

It reports ``init_s`` (the state made on the card), ``step_s`` (the force
pass and the integration, between two ``torch.cuda.synchronize()``), the
one-sided and unordered pairs/s of that step, and ``render_s`` (the frame
and its file), as the JAX tool's ``:115-126`` does.

    python -m parallel_nbody_tpu_torch.benchmarks.huge_n [N] [out.ppm] \\
        [--device=cpu] [--out=PATH]

prints the record as JSON and writes it to PATH (on the card by default
``benchmarks/results_huge.json`` beside this module).  Without a card it
exits 1; on the CPU, N defaults to ``CPU_N``.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import torch

from ..config import SimConfig
from ..models import engine
from ..ops.render import render_frame
from ..state import random_state
from ..utils import ppm
from ..utils.device import tool_argv
from ._tools import fingerprint, record_path, sync, wall, write_record

N = 10_000_000
CPU_N = 4096
SEED = 0


def huge_cfg() -> SimConfig:
    return SimConfig(force_mode="fast", dtype="float32", kernel="cuda")


def huge_step(device, n: int, out_ppm: str, log=print):
    """(record, stepped state) of one ``engine.step`` from the seeded
    ``random_state`` of ``n`` bodies."""
    cfg = huge_cfg()
    gen = torch.Generator(device=device).manual_seed(SEED)
    t_init, st = wall(lambda: random_state(n, cfg, gen, device=device),
                      device)
    log("N=%d: state made in %.3f s" % (n, t_init))
    t_step, out = wall(lambda: engine.step(cfg, st), device)
    if not all(bool(torch.isfinite(t).all()) for t in out):
        raise AssertionError("non-finite state after one step at N=%d" % n)
    log("N=%d: one step in %.3f s" % (n, t_step))

    def frame():
        pixels = render_frame(cfg, out.x, out.y, out.radius, n)
        sync(device)
        ppm.create(out_ppm, cfg.xdim, cfg.ydim, pixels.cpu().numpy())
        return pixels

    t_render, pixels = wall(frame, device)
    lit = int(pixels.any(dim=2).sum())
    log("N=%d: frame in %.3f s, %d lit pixels" % (n, t_render, lit))
    pairs = float(n) * n  # one-sided
    record = {
        "n": n,
        "init_s": t_init,
        "step_s": t_step,
        "one_sided_pairs_per_s": pairs / t_step,
        "unordered_pairs_per_s": pairs / 2 / t_step,
        "render_s": t_render,
        "lit_pixels": lit,
        "frame": out_ppm,
        "fingerprint": fingerprint(device),
    }
    return record, out


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    got = tool_argv("huge_n", argv)
    if got is None:
        return 1
    args, flags, device = got
    n = int(args[0]) if args else (N if device.type == "cuda" else CPU_N)
    out_ppm = (args[1] if len(args) > 1 else
               os.path.join(tempfile.gettempdir(), "nbody_huge_n.ppm"))
    record, _ = huge_step(device, n, out_ppm,
                          log=lambda s: print(s, flush=True))
    print(json.dumps(record))
    write_record(record, record_path(flags, device, "results_huge.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
