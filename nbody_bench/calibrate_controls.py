"""Controls of a float64 cell's limits: other paths of the port that must
fail them, read on the cell's own states.

    python3 -m nbody_bench.calibrate_controls --workload <cell> \
        --seeds 1,2,... [--controls k1_fp64,fp32] [--seconds 3]

For each seed and control, one whole run of the cell (``harness.run``:
set-up, a window of ``--seconds``, the check) whose control answers the
window's last step from the state the program's own last step started from,
held to the same float64 reference and judged by the cell's limits.  One
JSON line each, with the program's readings, the control's, and whether
the control passes (``control_correct``, which has to come out false).
The controls:

- ``k1_fp64``: the fast formula in float64, K1's fp64 instantiation with
  the coincidence flag (``force_mode="fast"``);
- ``fp32``: the port's float32 path (``force_mode="fast"``,
  ``dtype="float32"``; the symmetric pass to 131072 bodies), from the state
  rounded to float32: the precision below the cell's.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from parallel_nbody_tpu_torch.models import engine
from parallel_nbody_tpu_torch.state import State

from . import harness
from .run import MANIFEST

CONTROLS = {
    "k1_fp64": dict(force_mode="fast"),
    "fp32": dict(force_mode="fast", dtype="float32"),
}


def control(name):
    """The control ``name`` of ``CONTROLS`` as ``harness.run`` calls it."""
    def answer(cell, prev, frame_state):
        cfg = cell.sim.replace(**CONTROLS[name])
        out = engine.step(cfg, State(*(t.to(cfg.torch_dtype)
                                       for t in prev)))
        return {"step": {k: getattr(out, k).to(torch.float64).cpu()
                         for k in ("x", "y", "xv", "yv", "xf", "yf")}}
    return answer


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nbody_bench.calibrate_controls")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", default=",".join(CONTROLS))
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write("needs a CUDA device\n")
        return 1
    cell = harness.load_cell(MANIFEST, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        for name in args.controls.split(","):
            t = time.perf_counter()
            out = harness.run(cell, seed, args.seconds, False,
                              torch.device("cuda", 0), control=control(name))
            print(json.dumps({
                "workload": args.workload, "seed": seed, "control_name": name,
                "seconds": time.perf_counter() - t,
                "correct": out["correct"],
                "program": {k: v["value"] for k, v in out["checks"].items()},
                "control": out["control"],
                "control_correct": out["control_correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
