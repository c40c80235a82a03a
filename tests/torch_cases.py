"""Inputs shared by the port's kernel tests (imports no JAX, so the card
tests in test_torch_gpu.py can use it where JAX is absent)."""

import numpy as np

KICK = 38.5 / 9.0  # G * 5 * 7 / (1.5 + 1.5)^2, tests/test_coincident.py

BLOCK_CASES = ("square300", "rect256x384", "zero_mass")


def glibc_like(n, seed, coincident=((10, 20),)):
    """Integer-pixel positions (as the glibc init makes them) with the given
    coincident pairs, radii >= 1 and the reference mass law; float64
    arrays [x, y, mass, radius]."""
    rng = np.random.RandomState(seed)
    x = np.floor(rng.uniform(0, 1024, n))
    y = np.floor(rng.uniform(0, 768, n))
    for a, b in coincident:
        x[b], y[b] = x[a], y[a]
    r = 1.0 + rng.uniform(0, 5, n)
    return [x, y, r**3, r]


def bf16_ulps(got, want):
    """Elementwise distance in bf16 steps between two arrays of bf16
    values (given as anything numpy reads as float32)."""
    a = np.asarray(got, np.float32).view(np.int32)
    b = np.asarray(want, np.float32).view(np.int32)
    # Map the sign-magnitude bit patterns onto one ordered integer line.
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a) >> 16
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b) >> 16
    return np.abs(a.astype(np.int64) - b.astype(np.int64))


def blocks(case):
    """(rows, cols, row_g0, col_g0) of float64 arrays for one of
    BLOCK_CASES."""
    if case == "square300":
        b = glibc_like(300, 5, ((10, 20), (3, 299)))
        return b, b, 0, 0
    if case == "rect256x384":
        # Rows are global bodies 100..355 and columns 50..433 of a 434-body
        # set: coincident pairs inside the row block, across its edges and
        # in the overlap, where self-pairs sit off the block diagonal.
        full = glibc_like(434, 6, ((120, 130), (60, 200), (300, 420)))
        return ([a[100:356] for a in full], [a[50:434] for a in full],
                100, 50)
    if case == "zero_mass":
        x, y, m, r = glibc_like(300, 7, ((10, 20), (30, 40)))
        m[20] = 0.0  # a massless body coincident with a real one
        m[250:] = 0.0
        x[280:], y[280:], r[280:] = 1e9, 1e9, 0.0  # pad_state padding
        return [x, y, m, r], [x, y, m, r], 0, 0
    raise ValueError(case)
