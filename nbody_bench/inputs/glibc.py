"""The reference's own init: ``srand(seed)``, then for each body in order
``x = rand() % xdim``, ``y = rand() % ydim``,
``xv = ((rand() % 20000) - 10000) / 2000.0`` and the same for ``yv``
(nbody-seq.c:440-449).

``rand`` is glibc's default generator (TYPE_3, stdlib/random_r.c): a
degree-31 additive-feedback sequence over 32-bit words, seeded by a
Park-Miller recurrence evaluated with Schrage's method, 310 outputs
discarded, each output ``word >> 1``.  ``srand`` takes an unsigned int, so
the seed is taken modulo 2**32, and glibc stores it in a signed word.
Positions are whole pixels, so many bodies coincide.
"""

from __future__ import annotations

import numpy as np

from . import radius_mass

_MASK32 = 0xFFFFFFFF


def rand_stream(seed: int, count: int) -> np.ndarray:
    """The first ``count`` values of glibc ``rand()`` after
    ``srand(seed)``, as int64."""
    seed &= _MASK32
    if seed == 0:
        seed = 1
    word = seed - (1 << 32) if seed >= (1 << 31) else seed
    r = [word]
    for _ in range(1, 31):
        # C's '/' and '%' truncate toward zero: work on the magnitude.
        q, rem = divmod(abs(word), 127773)
        if word < 0:
            q, rem = -q, -rem
        word = 16807 * rem - 2836 * q
        if word < 0:
            word += 2147483647
        r.append(word)
    r += r[:3]
    r = [v & _MASK32 for v in r]
    total = 310 + count
    for i in range(34, 34 + total):
        r.append((r[i - 31] + r[i - 3]) & _MASK32)
    return np.array(r[34 + 310:], dtype=np.int64) >> 1


def make(n: int, xdim: int, ydim: int, seed: int):
    draws = rand_stream(seed, 4 * n).reshape(n, 4)
    x = (draws[:, 0] % xdim).astype(np.float64)
    y = (draws[:, 1] % ydim).astype(np.float64)
    xv = ((draws[:, 2] % 20000) - 10000) / 2000.0
    yv = ((draws[:, 3] % 20000) - 10000) / 2000.0
    mass, radius = radius_mass(n, xdim, ydim)
    return x, y, xv, yv, mass, radius
