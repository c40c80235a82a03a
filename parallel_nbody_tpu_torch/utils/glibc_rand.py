"""Bit-exact replica of glibc's ``rand()`` (TYPE_3 additive-feedback generator).

The reference initializes its simulation with ``srand(27102015)`` followed by a
fixed sequence of ``rand()`` calls (reference: nbody/nbody-seq.c:440-449).
Golden-output parity therefore requires reproducing glibc's default PRNG
exactly — ``torch.Generator`` cannot be used on the parity path.

glibc's default ``rand()`` is ``random()`` with the TYPE_3 configuration:
a degree-31, separation-3 additive-feedback generator over a 34-word int32
state.  Algorithm (see glibc stdlib/random_r.c):

  1. ``r[0] = seed`` (seed 0 is mapped to 1).
  2. ``r[i] = (16807 * r[i-1]) mod 2147483647`` for i in 1..30, evaluated with
     Schrage's method to avoid overflow.
  3. ``r[i] = r[i-31]`` for i in 31..33.
  4. Warm-up: generate and discard 310 outputs.
  5. Each output: ``r[i] = (r[i-31] + r[i-3]) mod 2**32``; result is
     ``r[i] >> 1`` (a 31-bit non-negative value).

Host-side and numpy-only: init draws 3 values per body, so this is never on
the device.  The C++ implementation in ``native/`` (bit-identical) is used
for large N through ``utils.native_bridge``.
"""

from __future__ import annotations

import numpy as np

_MASK32 = 0xFFFFFFFF


class GlibcRand:
    """Stateful replica of glibc ``srand``/``rand`` (TYPE_3)."""

    DEGREE = 31
    SEPARATION = 3
    STATE_WORDS = 34

    def __init__(self, seed: int):
        self.seed(seed)

    def seed(self, seed: int) -> None:
        seed = seed & _MASK32
        if seed == 0:
            seed = 1
        r = np.zeros(self.STATE_WORDS, dtype=np.int64)
        # glibc stores the unsigned seed into an int32_t word
        # (srandom_r, stdlib/random_r.c): two's-complement wrap, so seeds
        # >= 2**31 start the Schrage recurrence from a NEGATIVE word.
        word = seed - (1 << 32) if seed >= (1 << 31) else seed
        r[0] = word
        for i in range(1, self.DEGREE):
            # r[i] = (16807 * r[i-1]) % 2147483647 via Schrage.  C's signed
            # '/' and '%' truncate toward zero (Python's divmod floors), so
            # compute the quotient/remainder on the magnitude; this only
            # differs on the possibly-negative first word.
            q, rem = divmod(abs(word), 127773)
            if word < 0:
                q, rem = -q, -rem
            word = 16807 * rem - 2836 * q
            if word < 0:
                word += 2147483647
            r[i] = word
        for i in range(self.DEGREE, self.STATE_WORDS):
            r[i] = r[i - self.DEGREE]
        # Keep the logical sequence r[k]; each new word is r[k-31] + r[k-3].
        self._seq = [int(v) & _MASK32 for v in r]
        # Warm-up: discard 10 * DEGREE = 310 outputs.
        for _ in range(310):
            self._next_raw()

    def _next_raw(self) -> int:
        seq = self._seq
        val = (seq[-self.DEGREE] + seq[-self.SEPARATION]) & _MASK32
        seq.append(val)
        # Keep the tail bounded (only the last 31 words are ever needed).
        if len(seq) > 4 * self.STATE_WORDS:
            del seq[: -self.STATE_WORDS]
        return val >> 1

    def rand(self) -> int:
        """One ``rand()`` draw: uniform int in [0, 2**31 - 1]."""
        return self._next_raw()


def nbody_init_arrays(n: int, xdim: int, ydim: int, seed: int = 27102015):
    """Replicate the reference's initialization loop exactly.

    Reference semantics (nbody/nbody-seq.c:440-449): for each body b in order,
      x      = rand() % xdim
      y      = rand() % ydim
      radius = 1 + (b*b + 1.0) * sqrt(xdim^2 + ydim^2) / (25 * (n*n + 1.0))
      mass   = radius^3
      xv     = ((rand() % 20000) - 10000) / 2000.0
      yv     = ((rand() % 20000) - 10000) / 2000.0

    Returns float64 numpy arrays (x, y, xv, yv, mass, radius).  From 4096
    bodies on, the native C++ loop is used when its library loads.
    """
    from . import native_bridge
    if n >= 4096 and native_bridge.available():
        return native_bridge.nbody_init(n, xdim, ydim, seed)
    rng = GlibcRand(seed)
    x = np.empty(n, dtype=np.float64)
    y = np.empty(n, dtype=np.float64)
    xv = np.empty(n, dtype=np.float64)
    yv = np.empty(n, dtype=np.float64)
    mass = np.empty(n, dtype=np.float64)
    radius = np.empty(n, dtype=np.float64)
    diag = float(np.sqrt(1.0 * (xdim * xdim + ydim * ydim)))
    denom = 25.0 * (n * n + 1.0)
    for b in range(n):
        x[b] = rng.rand() % xdim
        y[b] = rng.rand() % ydim
        r = 1.0 + ((b * b + 1.0) * diag) / denom
        radius[b] = r
        mass[b] = r * r * r
        xv[b] = ((rng.rand() % 20000) - 10000) / 2000.0
        yv[b] = ((rng.rand() % 20000) - 10000) / 2000.0
    return x, y, xv, yv, mass, radius
