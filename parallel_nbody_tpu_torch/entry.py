"""Entry points: one compiled-path step, and the multi-rank dry run.

entry(device=None)    -> (fn, (state,)): ``fn(state)`` is one
                         ``engine.step`` of the speed configuration (fp32,
                         ``force_mode="fast"``, ``kernel="cuda"``: the
                         force kernel K1) on ``random_state(4096)`` drawn
                         from a ``torch.Generator`` seeded with 0.  On the
                         card unless ``device="cpu"`` asks for the CPU,
                         where the kernel's plain version runs.
dryrun_multichip(n)   -> None: runs ``python -m
                         parallel_nbody_tpu_torch.parallel.dryrun n`` (n
                         gloo ranks on the CPU, every distributed program
                         against the single-rank run) in a child process,
                         and raises RuntimeError with the child's output if
                         it fails.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

from .config import SimConfig
from .models.engine import step
from .state import random_state
from .utils.device import resolve

N_ENTRY = 4096
SEED = 0


def entry(device=None):
    """(fn, (state,)) for one engine step of the speed configuration."""
    device = resolve(device)
    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
    gen = torch.Generator(device=device).manual_seed(SEED)
    state = random_state(N_ENTRY, cfg, gen, device=device)

    def fn(s):
        return step(cfg, s)

    return fn, (state,)


def dryrun_multichip(n_devices: int) -> None:
    """Run the distributed programs over ``n_devices`` gloo ranks on the
    CPU in a child process; raise RuntimeError if it fails.  The child's
    report goes to stderr."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "parallel_nbody_tpu_torch.parallel.dryrun",
         str(n_devices)],
        cwd=repo, env=env, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(
            "dryrun_multichip child failed (rc=%d)\nstdout:\n%s\nstderr:\n%s"
            % (proc.returncode, proc.stdout[-2000:], proc.stderr[-4000:]))
    sys.stderr.write(proc.stdout)
