"""One simulation step at N=10,000,000 on one card (BASELINE config 5's
single-chip scale), and a frame of the result.

The counterpart of the JAX package's ``benchmarks/huge_n.py``, with its
argv: the ``random_state`` of N bodies (a ``torch.Generator`` seeded with 0)
in fp32; one step of ``engine.make_hosted_row_step(cfg, N, row_chunk)``,
which runs ``any_coincident`` once and the force pass through K2
(``block_forces_streamed``, band 65536) in ``ceil(N / row_chunk)`` launches,
each of ``row_chunk`` rows (the last one the rest) against all N columns,
then velocity and position integration; then
``ops/render.render_frame_hosted`` of the new positions, written as a P6
PPM.  K2's workspace of band partials is bands x 2 x rows in fp32: over all
N rows at once it would be about N**2 / 8192 bytes (12.2 GB at N=10M), and
a row chunk bounds it by bands x 2 x row_chunk (0.61 GB at N=10M and the
default chunk).  The JAX tool cuts the same chunks to keep each TPU
dispatch under its transport's limit of about a minute; a CUDA launch has
no such limit, and the chunks are for memory alone.  The CLI's
``engine.step`` cuts the same launches, sized by
``ops.cuda_step.K2_WORKSPACE_BYTES`` (1 GiB) instead of a chunk of rows.

It reports ``init_s`` (the state made on the card), ``step_s`` (the force
pass and the integration, between two ``torch.cuda.synchronize()``), the
one-sided and unordered pairs/s of that step, ``row_chunk`` and ``chunks``,
``step_peak_bytes`` (``torch.cuda.max_memory_allocated`` over the step, the
peak statistics reset just before it; on the CPU it is not measured, null)
and ``render_s`` (the frame and its file), as the JAX tool's ``:115-126``
does.

    python -m parallel_nbody_tpu_torch.benchmarks.huge_n [N] [row_chunk] \\
        [out.ppm] [--device=cpu] [--out=PATH]

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
from ..ops.render import render_frame_hosted
from ..state import random_state
from ..utils import ppm
from ..utils.device import tool_argv
from ._tools import fingerprint, record_path, wall, write_record

N = 10_000_000
CPU_N = 4096
ROW_CHUNK = 500_000  # the JAX tool's
SEED = 0


def huge_cfg() -> SimConfig:
    return SimConfig(force_mode="fast", dtype="float32", kernel="cuda")


def huge_step(device, n: int, out_ppm: str, log=print,
              row_chunk: int = ROW_CHUNK):
    """(record, stepped state) of one ``make_hosted_row_step`` step from
    the seeded ``random_state`` of ``n`` bodies."""
    cfg = huge_cfg()
    gen = torch.Generator(device=device).manual_seed(SEED)
    t_init, st = wall(lambda: random_state(n, cfg, gen, device=device),
                      device)
    log("N=%d: state made in %.3f s" % (n, t_init))
    step_fn, warmup = engine.make_hosted_row_step(cfg, n, row_chunk)
    chunks = -(-n // row_chunk)
    if device.type == "cuda":
        warmup()
        torch.cuda.reset_peak_memory_stats(device)
    t_step, out = wall(lambda: step_fn(st), device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    if not all(bool(torch.isfinite(t).all()) for t in out):
        raise AssertionError("non-finite state after one step at N=%d" % n)
    log("N=%d: one step in %d row chunks of %d in %.3f s, peak %s bytes"
        % (n, chunks, row_chunk, t_step, peak))

    def frame():
        pixels = render_frame_hosted(cfg, out.x, out.y, out.radius, n)
        ppm.create(out_ppm, cfg.xdim, cfg.ydim, pixels)
        return pixels

    t_render, pixels = wall(frame, device)
    lit = int(pixels.any(axis=2).sum())
    log("N=%d: frame in %.3f s, %d lit pixels" % (n, t_render, lit))
    pairs = float(n) * n  # one-sided
    record = {
        "n": n,
        "init_s": t_init,
        "step_s": t_step,
        "one_sided_pairs_per_s": pairs / t_step,
        "unordered_pairs_per_s": pairs / 2 / t_step,
        "row_chunk": row_chunk,
        "chunks": chunks,
        "step_peak_bytes": peak,
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
    row_chunk = int(args[1]) if len(args) > 1 else ROW_CHUNK
    if row_chunk < 1:
        sys.stderr.write("huge_n: row_chunk must be >= 1, got %d\n"
                         % row_chunk)
        return 1
    out_ppm = (args[2] if len(args) > 2 else
               os.path.join(tempfile.gettempdir(), "nbody_huge_n.ppm"))
    record, _ = huge_step(device, n, out_ppm,
                          log=lambda s: print(s, flush=True),
                          row_chunk=row_chunk)
    print(json.dumps(record))
    write_record(record, record_path(flags, device, "results_huge.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
