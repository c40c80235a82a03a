"""Readings for the limits of ``correct``: the program's and its control's.

    python3 -m nbody_bench.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 3]

Runs the cell's whole run (set-up, a window of ``--seconds``, the check) for
each seed in one process, and prints one JSON line per seed with the
program's readings.  On the control seeds it also reads the control: the
port's bfloat16 path (``SimConfig(dtype="bfloat16")``: bfloat16 storage,
float32 sums in K1 and K2), the precision below the configured float32,
given the same state as the window's last step (rounded to bfloat16) and,
in frame mixes, the last frame's state; its answers are held to the same
float64 reference and judged by the cell's limits (``control_correct``,
which has to come out false).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from parallel_nbody_tpu_torch.models import engine
from parallel_nbody_tpu_torch.ops.render import render_frame
from parallel_nbody_tpu_torch.state import State

from . import harness
from .run import MANIFEST

LOW = torch.bfloat16


def bf16_control(cell, prev, frame_state):
    """The control's answers from the program's own state ``prev``."""
    cfg = cell.sim.replace(dtype="bfloat16")
    out = engine.step(cfg, State(*(t.to(LOW) for t in prev)))
    ans = {"step": {k: getattr(out, k).to(torch.float64).cpu()
                    for k in ("x", "y", "xv", "yv", "xf", "yf")}}
    if frame_state is not None:
        fs = frame_state
        ans["frame"] = render_frame(cfg, fs.x.to(LOW), fs.y.to(LOW),
                                    fs.radius.to(LOW),
                                    fs.x.shape[0]).cpu().numpy()
    return ans


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nbody_bench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write("needs a CUDA device\n")
        return 1
    cell = harness.load_cell(MANIFEST, args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = harness.run(cell, seed, args.seconds, False,
                          torch.device("cuda", 0),
                          control=bf16_control if seed in controls else None)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "seconds": time.perf_counter() - t,
            "reference_s": out["reference_s"],
            "correct": out["correct"],
            "metrics": {k: v["value"] for k, v in out["metrics"].items()},
            "program": {k: v["value"] for k, v in out["checks"].items()},
            "control": out.get("control"),
            "control_correct": out.get("control_correct"),
            "phases": out["phases"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
