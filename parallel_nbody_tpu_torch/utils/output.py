"""Output contract of the reference program.

``print`` (nbody-seq.c:356-365) emits one line per body:
``"%10.3f %10.3f %10.3f %10.3f %10.3f %10.3f\n"`` of
(x, y, xf, yf, xv, yv) — final positions/velocities, last step's forces.
The experiment CSV (``--run-xps``) format follows nbody-seq.c:488.

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
