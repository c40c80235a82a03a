"""One side of a parent-against-change comparison of K1, K2 and the
headline's step on one card.

It times whichever ``parallel_nbody_tpu_torch`` package Python imports, so
the same file runs against two checkouts in turn:

    PYTHONPATH=PARENT python parallel_nbody_tpu_torch/benchmarks/kernel_ab.py parent
    PYTHONPATH=.      python parallel_nbody_tpu_torch/benchmarks/kernel_ab.py change

Run the two sides alternately in one call to the card, swapping which goes
first in each pair (parent, change, change, parent, ...), and compare the
medians of the pairs.  It uses only the package's public calls that every
version since the kernels' redesign has (``block_forces``,
``block_forces_streamed`` with their reference versions, ``engine.run``,
``random_state``).  Each side prints one line, ``AB {json}``:

  - ``err_{K1,K2}_{u,b}``: each kernel against its plain version on 4000
    rows (``row_g0`` = 3) of 4999 columns (K2 in bands of 1024), unbiased
    and biased, as max|err| / max|F|;
  - ``K1_{u,b}_ms``: ``block_forces`` at N=65536, best of 30 by CUDA
    events: K1, or the symmetric pass in a version that has it;
  - ``K2_{u,b}_ms``: K2 at N=262144, best of 5 by CUDA events;
  - ``headline_pairs_per_s``: ``engine.run`` at N=65536 for 100 steps, best
    of 3 after a warm-up step, on the host clock between
    ``torch.cuda.synchronize()`` calls: the shape of ``bench``.

Inputs are ``random_state`` from a ``torch.Generator`` seeded with 0 on the
card.  Without a card it exits 1.
"""

import json
import sys
import time

import torch

from parallel_nbody_tpu_torch.config import SimConfig
from parallel_nbody_tpu_torch.models.engine import run
from parallel_nbody_tpu_torch.ops import cuda_step
from parallel_nbody_tpu_torch.state import random_state

HOLD_ROWS, HOLD_COLS, HOLD_BAND = 4000, 4999, 1024


def _state(n, cfg, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    return random_state(n, cfg, gen, device=dev)


def _best_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def measure(label: str) -> dict:
    dev = torch.device("cuda")
    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
    res = {"label": label}

    st = _state(HOLD_COLS, cfg, dev)
    full = (st.x, st.y, st.mass, st.radius)
    rows = [t[:HOLD_ROWS] for t in full]
    kernels = {
        "K1": (cuda_step.block_forces, cuda_step.block_forces_reference, {}),
        "K2": (cuda_step.block_forces_streamed,
               cuda_step.block_forces_streamed_reference,
               {"band": HOLD_BAND})}
    for name, (fn, ref, kw) in kernels.items():
        for biased in (False, True):
            got = fn(cfg, *rows, *full, row_g0=3, col_g0=0, biased=biased,
                     **kw)
            want = ref(cfg, *[t.cpu() for t in rows],
                       *[t.cpu() for t in full], row_g0=3, col_g0=0,
                       biased=biased, **kw)
            res["err_%s_%s" % (name, "b" if biased else "u")] = max(
                float((g.cpu() - w).abs().max() / w.abs().max())
                for g, w in zip(got, want))

    for name, fn, n, reps in (("K1", cuda_step.block_forces, 65536, 30),
                              ("K2", cuda_step.block_forces_streamed,
                               262144, 5)):
        st = _state(n, cfg, dev)
        cols = (st.x, st.y, st.mass, st.radius)
        for biased in (False, True):
            res["%s_%s_ms" % (name, "b" if biased else "u")] = _best_ms(
                lambda: fn(cfg, *cols, *cols, biased=biased), reps)

    n, steps = 65536, 100
    st = _state(n, cfg, dev)
    run(cfg, st, 1)
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(cfg, st, steps)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    res["headline_pairs_per_s"] = n * (n - 1) / 2 * steps / best
    return res


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    if not torch.cuda.is_available():
        sys.stderr.write("kernel_ab: no CUDA device is available\n")
        return 1
    print("AB " + json.dumps(measure(argv[1] if len(argv) > 1 else "")),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
