"""Inputs and helpers shared by the port's tests (imports no JAX, so the
card tests in test_torch_gpu.py can use it where JAX is absent)."""

import os
import signal
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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


# Blocks of one N=2300 glibc-like set for the Pallas geometry (1024-row
# blocks, 1024-wide tiles): case -> (row_g0, col_g0), rows and columns
# running to the end of the set.  Coincident pairs (global ids) put the kick
# in every segment of the dx bias: with rows from 0, (5, 1900) and
# (1000, 1050) in a tile below and a tile above, (700, 900) and (1100, 1500)
# in the overlapping tile; with rows from 600 each row block overlaps two
# tiles, which hold (1000, 1050), (700, 900) and (1100, 1500), and
# (5, 1900) and (650, 2200) fall below and above.
SEGMENT_PAIRS = ((5, 1900), (700, 900), (1100, 1500), (1000, 1050),
                 (650, 2200))
SEGMENT_CASES = {"square": (0, 0), "rows_from_600": (600, 0)}


def segment_blocks(case):
    """(rows, cols, row_g0, col_g0) of float64 arrays for one of
    SEGMENT_CASES."""
    full = glibc_like(2300, 40, SEGMENT_PAIRS)
    g0, c0 = SEGMENT_CASES[case]
    return [a[g0:] for a in full], [a[c0:] for a in full], g0, c0


# A coincident pair (global ids a < b) and the row and column blocks (global
# id ranges) that put each of its two terms in a segment of the kernels'
# 128/128 bias: (term of row a, term of row b) is in the overlapping tile
# ("pair"), a tile wholly below ("below") or wholly above ("above").  With
# row_g0 = 37 and col_g0 = 90 each row block overlaps two column tiles, and
# the "misaligned" pair's two terms fall one in each.
KICK_PLACEMENTS = {
    "same_tile": ((3, 50), (0, 256), (0, 256), ("pair", "pair")),
    "tiles_apart": ((5, 300), (0, 384), (0, 384), ("above", "below")),
    "misaligned": ((200, 230), (37, 437), (90, 600), ("pair", "pair")),
    "misaligned_apart": ((100, 400), (37, 437), (90, 600),
                         ("above", "below")),
}


def kick_case(name):
    """(rows, cols, row_g0, col_g0, (ia, ib)) for one of KICK_PLACEMENTS:
    bodies a and b (masses 5 and 7, radius 1.5) at (100, 200), every other
    body massless and far (state.pad_state's padding), so a's and b's x
    forces are the kick +-KICK and nothing else; ia, ib index the rows."""
    (a, b), (r0, r1), (c0, c1), _ = KICK_PLACEMENTS[name]
    n = max(r1, c1)
    x, y = np.full(n, 1e9), np.full(n, 1e9)
    m, r = np.zeros(n), np.zeros(n)
    x[[a, b]], y[[a, b]] = 100.0, 200.0
    m[a], m[b] = 5.0, 7.0
    r[[a, b]] = 1.5
    full = (x, y, m, r)
    return ([v[r0:r1] for v in full], [v[c0:c1] for v in full], r0, c0,
            (a - r0, b - r0))


# Rows of the probes' square input that share a position: bodies 7 and 300,
# and 10 and 11.
PROBE_COINCIDENT = ((7, 300), (10, 11))


def probe_inputs(n, seed, square=False):
    """Eight float32 arrays (xi, yi, mi, ri, xj, yj, mj, rj), uniform in
    [1, 2) as the probes draw them.  Independent rows and columns, or with
    ``square`` the columns equal to the rows and the PROBE_COINCIDENT pairs
    at one position."""
    rng = np.random.RandomState(seed)
    rows = [rng.uniform(1, 2, n).astype(np.float32) for _ in range(4)]
    if not square:
        return rows + [rng.uniform(1, 2, n).astype(np.float32)
                       for _ in range(4)]
    for a, b in PROBE_COINCIDENT:
        rows[0][b], rows[1][b] = rows[0][a], rows[1][a]
    return rows + [a.copy() for a in rows]


def spawned(args, timeout=180):
    """Run ``python args...`` from the repo on the CPU (NBODY_PLATFORM=cpu,
    one thread per process) in a new session: a multi-process case with a
    timeout of its own.  Returns (rc, stdout, stderr); at the timeout the
    whole session — the command and every rank it started — is killed and
    AssertionError raised."""
    env = dict(os.environ, NBODY_PLATFORM="cpu", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable] + args, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=REPO, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError("%s: still running after %d s, process group "
                             "killed" % (" ".join(args), timeout))
    return proc.returncode, out, err
