"""Output contract of the reference program.

``print`` (nbody-seq.c:356-365) emits one line per body:
``"%10.3f %10.3f %10.3f %10.3f %10.3f %10.3f\n"`` of
(x, y, xf, yf, xv, yv) — final positions/velocities, last step's forces.
The experiment CSV (``--run-xps``) formats follow nbody-seq.c:488 and
nbody-par.c:954-957.

This is the only place where the state's tensors go to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..state import State

_LINE = "%10.3f %10.3f %10.3f %10.3f %10.3f %10.3f"


def _host64(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(device="cpu", dtype=torch.float64).numpy()


def format_state(state: State) -> str:
    """Byte-identical rendering of the reference's final-state printout
    (the native snprintf formatter when built, else Python % formatting,
    verified byte-identical)."""
    x, y, xf, yf, xv, yv = (_host64(t) for t in (
        state.x, state.y, state.xf, state.yf, state.xv, state.yv))

    from . import native_bridge
    native = native_bridge.format_state_native(x, y, xf, yf, xv, yv)
    if native is not None:
        return native

    lines = [
        _LINE % (x[b], y[b], xf[b], yf[b], xv[b], yv[b])
        for b in range(x.shape[0])
    ]
    return "\n".join(lines) + "\n"


def nr_flops(n: int, steps: int) -> int:
    """The reference's analytic FLOP model (nbody-seq.c:367-380)."""
    per_step = 20 * (n * (n - 1) // 2) + 18 * n + 4 * n
    return per_step * steps


def pair_interactions(n: int, steps: int) -> int:
    """Unordered pairwise interactions evaluated (the benchmark currency)."""
    return steps * n * (n - 1) // 2


def xps_csv_seq(n: int, rtime: float, gflops: float) -> str:
    """Sequential experiment CSV row (nbody-seq.c:488): NBODIES,RTIME,GFLOPS."""
    return "%d,%.3f, %.2f" % (n, rtime, gflops)


def xps_csv_par(size: int, nodes: int, cpus_per_node: int, n: int,
                rtime: float, comm_time: float, gflops: float,
                precise: bool = False) -> str:
    """Parallel experiment CSV row (nbody-par.c:956):
    ``"%d,%d,%d,%d,%.3f,%.3f,%.3f,%.2f"`` for
    SIZE,NODES,CPUS_PER_NODE,NBODIES,RTIME,COMMTIME,RATIO,GFLOPS (no space
    before GFLOPS — only the SEQ row has one, nbody-seq.c:488).

    ``precise=True`` (CLI ``--xps-precise``) widens COMMTIME/RATIO to 6
    decimals, so that per-step collectives well under a millisecond stay
    distinguishable from zero; it leaves the reference's byte contract,
    which is why it is opt-in."""
    ratio = comm_time / rtime if rtime > 0 else 0.0
    fmt = ("%d,%d,%d,%d,%.3f,%.6f,%.6f,%.2f" if precise
           else "%d,%d,%d,%d,%.3f,%.3f,%.3f,%.2f")
    return fmt % (size, nodes, cpus_per_node, n, rtime, comm_time, ratio,
                  gflops)
