"""Which side of a printed digit's rounding boundary a force lands on, by the
arithmetic that computes it.

    python bin/torch/boundary_digits.py STATE.npz ROW [ROW...]

STATE.npz is a checkpoint of the port's CLI (``--checkpoint=STATE.npz``);
for each ROW it prints that body's y-force, the one the next step computes
from the saved positions, four ways, each with the digits the reference's
``%10.3f`` prints:

  - exact: the sum in 60-digit decimal arithmetic;
  - the fast formula (K1's and the TPU kernel's; K1's plain version) in
    its tile order, and its terms added in column order;
  - the reference's own trig arithmetic (nbody-seq.c:79-109: each pair
    from its lower-index body, atan2, cos and sin) in column order, the
    reference's.

A state saved one step before a printout that differs from the reference
shows which of them reach the reference's digit.  To make one on the card:
``python -m parallel_nbody_tpu_torch.cli 10000 0 arena.ppm 99 --pallas
--dtype=float64 --checkpoint=s99.npz``.  Runs on the CPU, seconds a row.
"""

import decimal
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from parallel_nbody_tpu_torch.config import SimConfig  # noqa: E402
from parallel_nbody_tpu_torch.ops import cuda_step  # noqa: E402

FAST = SimConfig(force_mode="fast", dtype="float64", kernel="cuda")
TILE = cuda_step.TILE


def exact_y(x, y, m, r, i, gravity):
    """G m_i sum_j m_j dy / (forced |d|) over j != i, in 60 digits."""
    decimal.getcontext().prec = 60
    D = decimal.Decimal
    xi, yi, ri = D(x[i]), D(y[i]), D(r[i])
    total = D(0)
    for j in range(len(x)):
        if j != i:
            dx, dy = D(x[j]) - xi, D(y[j]) - yi
            dsqr = dx * dx + dy * dy
            forced = max(dsqr, (ri + D(r[j])) ** 2)
            total += D(m[j]) * dy / (forced * dsqr.sqrt())
    return total * D(m[i]) * D(gravity)


def fast_terms(x, y, m, r, i, biased):
    """Row i's y-terms of the fast formula as K1 forms them: its 128-row
    block's dx bias where ``biased``, the plain version's operations."""
    dx = x - x[i]
    if biased:
        i0 = i - i % TILE
        dx = dx + cuda_step.dx_bias(range(i - i0, i - i0 + 1), len(x),
                                    row_g0=i0, col_g0=0, row_block=TILE,
                                    tile=TILE, dtype=x.dtype)[0]
    dy = y - y[i]
    dsqr = dx * dx + dy * dy
    mind = r[i] + r
    forced = torch.maximum(dsqr, mind * mind)
    eps = cuda_step._EPS[x.dtype]
    return m * torch.rsqrt(forced * forced * dsqr + eps) * dy


def trig_terms(x, y, m, r, i, gravity):
    """Row i's y-terms of the reference's arithmetic: for a column j > i
    the pair as i sees it; for j < i the pair as j sees it, subtracted;
    +0 for j == i."""
    lower = torch.arange(len(x)) < i
    dx = torch.where(lower, x[i] - x, x - x[i])
    dy = torch.where(lower, y[i] - y, y - y[i])
    angle = torch.atan2(dy, dx)
    dsqr = dx * dx + dy * dy
    mind = r[i] + r
    forced = torch.maximum(dsqr, mind * mind)
    term = m[i] * m * gravity / forced * torch.sin(angle)
    term = torch.where(lower, 0.0 - term, term)
    term[i] = 0.0
    return term


def row_y_forces(state, i):
    """{way: the y-force on body i} for the four ways above."""
    x, y, m, r = (torch.from_numpy(state[f])
                  for f in ("x", "y", "mass", "radius"))
    biased = bool(cuda_step.any_coincident(x, y, m))
    i0 = i - i % TILE
    block = [t[i0:i0 + TILE] for t in (x, y, m, r)]
    return biased, {
        "exact": exact_y(*(state[f].tolist() for f in ("x", "y", "mass",
                                                       "radius")), i,
                         FAST.gravity),
        "fast formula, tile order": float(cuda_step.block_forces(
            FAST, *block, x, y, m, r, row_g0=i0, biased=biased)[1][i - i0]),
        "fast formula, column order": float(
            (0.0 + torch.cumsum(fast_terms(x, y, m, r, i, biased), 0)[-1])
            * (m[i] * FAST.gravity)),
        "trig, column order": float(
            0.0 + torch.cumsum(trig_terms(x, y, m, r, i, FAST.gravity),
                               0)[-1]),
    }


def main(argv):
    if len(argv) < 3:
        sys.stderr.write(__doc__)
        return 2
    with np.load(argv[1]) as z:
        state = {f: z[f] for f in z.files}
    torch.set_num_threads(1)
    print("state %s: step %d, %d bodies" % (argv[1], int(state["step"]),
                                           len(state["x"])))
    for i in map(int, argv[2:]):
        biased, ways = row_y_forces(state, i)
        print("body %d: the next force pass is %s" % (
            i, "biased (a coincident pair)" if biased else "unbiased"))
        for way, v in ways.items():
            print("body %d y-force %-28s %s -> %.3f" % (i, way, v, v))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
