"""Record an animation: run the simulation on the card, rasterize frames
there, and write a numbered P6 PPM sequence.

The counterpart of the JAX package's ``examples/animate.py``.  The
reference renders into one mmapped PPM on a wall-clock cadence
(nbody-seq.c:467-471), which is lossy and depends on timing; this example
records with ``engine.run_trajectory`` instead, so every frame is an exact
simulation state and the sequence is reproducible.

    python -m parallel_nbody_tpu_torch.examples.animate [N] [steps] \\
        [record_every] [outdir] [--device=cpu|cuda]

The simulation is the glibc init of N bodies in ``force_mode="fast"``
through the force kernels (``kernel="cuda"``): fp32 on the card, fp64 on
the CPU (their plain versions), as the JAX example picks by backend.  It
exits 1 without a CUDA device unless ``--device=cpu``.  Convert the frames
to a video with e.g. ``ffmpeg -i frames/frame_%04d.ppm out.mp4``.
"""

from __future__ import annotations

import os
import sys

from ..config import SimConfig
from ..models.engine import run_trajectory
from ..ops.render import render_frame
from ..state import init_state
from ..utils import ppm
from ..utils.device import resolve, tool_argv


def record(n: int, steps: int, every: int, outdir: str, device=None):
    """Run ``steps`` steps of ``n`` bodies on ``device`` (the card unless
    "cpu" is asked for), render the position every ``every`` steps and
    write it to ``outdir/frame_%04d.ppm``.  Returns (cfg, xs, ys, radius,
    paths): the recorded positions, the bodies' radii, and the files in
    order."""
    device = resolve(device)
    cfg = SimConfig(force_mode="fast", kernel="cuda",
                    dtype="float32" if device.type == "cuda" else "float64")
    state = init_state(n, cfg, device=device)
    _, xs, ys = run_trajectory(cfg, state, steps, record_every=every)
    os.makedirs(outdir, exist_ok=True)
    paths = []
    for i in range(xs.shape[0]):
        frame = render_frame(cfg, xs[i], ys[i], state.radius, n)
        paths.append(os.path.join(outdir, "frame_%04d.ppm" % i))
        ppm.create(paths[-1], cfg.xdim, cfg.ydim, frame.cpu().numpy())
    return cfg, xs, ys, state.radius, paths


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    got = tool_argv("animate", argv, ("device",))
    if got is None:
        return 1
    args, _, device = got
    n = int(args[0]) if len(args) > 0 else 256
    steps = int(args[1]) if len(args) > 1 else 2000
    every = int(args[2]) if len(args) > 2 else 100
    outdir = args[3] if len(args) > 3 else "frames"
    cfg, xs, _, _, _ = record(n, steps, every, outdir, device)
    print("wrote %d frames (%dx%d) to %s/"
          % (xs.shape[0], cfg.xdim, cfg.ydim, outdir))
    return 0


if __name__ == "__main__":
    sys.exit(main())
