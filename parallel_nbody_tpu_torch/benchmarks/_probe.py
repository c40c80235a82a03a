"""What the two probes share: the pair arithmetic of all their variants in
plain PyTorch, in two summation orders, the input checks, the kernel launch
and the timing loop.

Two plain versions compute the same pair terms and differ only in the order
they sum them:

- ``reference``, the Pallas probes' order: each row is summed over every
  ``tile_j``-wide column slice, and the slice sums are folded in order, as
  ``make_kernel``'s ``fori_loop`` adds each tile's row sums to its
  accumulator.  The CPU tests hold it to the Pallas probes.
- ``kernel_order``, the CUDA kernels' order (``csrc/probe_layout.cuh``):
  the columns cut into ``SPLIT`` parts of whole 128-column tiles, each part
  folded over its tiles in order, and the part sums folded in rank order.
  The wrappers run it on CPU tensors, and the card holds the kernels to it.
  (Within a 128-column tile the kernel adds term by term and the plain
  version sums the tile as ``torch.sum`` does; the tolerances cover that.)

Then ``F_i = acc_i * (m_i * 1.1)``.
"""

from __future__ import annotations

import subprocess
import time

import torch

from ..ops import _build

BIAS = 2.0 ** -50
CBIAS = 2.0 ** -26
# The probes' G (make_kernel's ``* 1.1``).
GRAVITY = 1.1
# The kernels' staged column tile (kBlock in csrc/pairs.cuh).
TILE = 128
# The row loops' layout (kRows and kSplit in csrc/probe_layout.cuh): rows
# per thread, and the parts the columns are split into.  The tensor-core
# variants take no split.
ROWS, SPLIT = 4, 2
TF32_VARIANTS = ("mxu2_r2", "bias1_mxu2")
# Variants whose de-NaN floor is max(q, 1e-30); the others of P2 add 1e-36.
_MAX_EPS = ("full", "no_rsqrt", "r2", "bias2_max", "mxu2_r2")
_BIAS1 = ("bias1_const", "bias1_fma", "bias1_mxu2")
# Elements per (rows, n) intermediate of the plain version: 16M elements is
# 64 MiB in fp32, so n = 65536 fits on the card 256 rows at a time.
_CHUNK_ELEMS = 1 << 24


def check(name, variants, variant, tensors, tile_i, tile_j):
    """Raise on what the probe kernels do not take: an unknown variant,
    tensors that are not fp32, 1-D, contiguous, of one length and on one
    device, or tiles that do not cut n into whole 128-wide tiles.  (The
    Pallas probes silently drop a ragged tail; the port refuses it.)"""
    if variant not in variants:
        raise ValueError("%s: unknown variant %r (expected one of %s)"
                         % (name, variant, ", ".join(variants)))
    ref = tensors[0]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError("%s: dtype %s (the probes are fp32 only)"
                            % (name, t.dtype))
        if t.device != ref.device:
            raise ValueError("%s: tensors on %s and %s"
                             % (name, ref.device, t.device))
        if t.dim() != 1 or not t.is_contiguous() or t.shape != ref.shape:
            raise ValueError("%s: expected 8 contiguous 1-D tensors of one "
                             "length, got shape %s" % (name, tuple(t.shape)))
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError("%s: unsupported device %s" % (name, ref.device))
    n = ref.shape[0]
    for tile in (tile_i, tile_j):
        if tile <= 0 or tile % TILE:
            raise ValueError("%s: tile %d is not a positive multiple of %d"
                             % (name, tile, TILE))
    if n == 0 or n % tile_i or n % tile_j:
        raise ValueError("%s: n=%d is not a positive multiple of tile_i=%d "
                         "and tile_j=%d" % (name, n, tile_i, tile_j))


def _pair_terms(variant, xi, yi, ri, bi, row0, xj, yj, mj, rj, bj, col0,
                tile_i, tile_j):
    """(mj * inv * dx, mj * inv * dy) of shape (rows, n): the Pallas probes'
    pair arithmetic, operation for operation."""
    dx = xj[None, :] - xi[:, None]
    if variant in _BIAS1:
        dx = dx + CBIAS
    elif variant in ("bias2_max", "bias2_fma"):
        dx = dx + (bj[None, :] - bi[:, None])
    elif variant == "bias_cond":
        r0, c0 = row0[:, None], col0[None, :]
        overlap = (r0 < c0 + tile_j) & (c0 < r0 + tile_i)
        plus = torch.tensor(CBIAS, dtype=dx.dtype, device=dx.device)
        const = torch.where(c0 > r0, plus, -plus)
        dx = dx + torch.where(overlap, bj[None, :] - bi[:, None], const)
    dy = yj[None, :] - yi[:, None]
    if variant == "mem_only":
        inv = dx + dy + mj[None, :] + rj[None, :]
    else:
        dsqr = dx * dx + dy * dy
        if variant == "no_soften":
            inv = torch.rsqrt(torch.clamp_min(dsqr * dsqr * dsqr, 1e-30))
        else:
            mind = ri[:, None] + rj[None, :]
            forced = torch.maximum(dsqr, mind * mind)
            q = forced * forced * dsqr
            if variant == "no_rsqrt":
                inv = torch.clamp_min(q, 1e-30) * 1e-6
            elif variant in _MAX_EPS:
                inv = torch.rsqrt(torch.clamp_min(q, 1e-30))
            else:
                inv = torch.rsqrt(q + 1e-36)
    scale = mj[None, :] * inv
    return scale * dx, scale * dy


def _tile_sums(variant, tensors, tile_i, tile_j, width, magnitudes):
    """The pair terms of every row summed over each ``width``-wide column
    slice: two (n, n / width) tensors, and with ``magnitudes`` the (2, n)
    sums of |term| over all columns."""
    xi, yi, mi, ri, xj, yj, mj, rj = tensors
    n, dev = xi.shape[0], xi.device
    nt = n // width
    ids = torch.arange(n, device=dev)
    b = ids.to(torch.float32) * BIAS
    row0, col0 = ids - ids % tile_i, ids - ids % tile_j
    px = torch.empty((n, nt), dtype=torch.float32, device=dev)
    py = torch.empty_like(px)
    mag = torch.empty((2, n), dtype=torch.float32, device=dev)
    chunk = max(1, _CHUNK_ELEMS // n)
    for r0 in range(0, n, chunk):
        rows = slice(r0, min(n, r0 + chunk))
        tx, ty = _pair_terms(variant, xi[rows], yi[rows], ri[rows], b[rows],
                             row0[rows], xj, yj, mj, rj, b, col0, tile_i,
                             tile_j)
        px[rows] = tx.view(-1, nt, width).sum(2)
        py[rows] = ty.view(-1, nt, width).sum(2)
        if magnitudes:
            mag[0, rows] = tx.abs().sum(1)
            mag[1, rows] = ty.abs().sum(1)
    return px, py, mag


def _fold(px, py):
    """The columns of (n, T) partial sums folded in order."""
    ax = torch.zeros(px.shape[0], dtype=torch.float32, device=px.device)
    ay = torch.zeros_like(ax)
    for vx, vy in zip(px.t(), py.t()):
        ax = ax + vx
        ay = ay + vy
    return ax, ay


def _finish(ax, ay, mi, mag, magnitudes):
    gmi = mi * GRAVITY
    if magnitudes:
        return ax * gmi, ay * gmi, mag[0] * gmi.abs(), mag[1] * gmi.abs()
    return ax * gmi, ay * gmi


def reference(variant, tensors, tile_i, tile_j, magnitudes=False):
    """The plain version of every probe variant in the Pallas probes' order
    (``tensors`` are xi, yi, mi, ri, xj, yj, mj, rj, checked by the
    caller).  Returns (xf, yf) or, with ``magnitudes``, (xf, yf, xmag,
    ymag), where ``xmag_i`` is ``|m_i * 1.1| * sum_j |x term_ij|``: the
    scale of the tf32 error bound of the tensor-core variants."""
    px, py, mag = _tile_sums(variant, tensors, tile_i, tile_j, tile_j,
                             magnitudes)
    return _finish(*_fold(px, py), tensors[2], mag, magnitudes)


def split_of(variant):
    """The column split of ``variant``'s kernel."""
    return 1 if variant in TF32_VARIANTS else SPLIT


def kernel_order(variant, tensors, tile_i, tile_j, split, magnitudes=False):
    """The plain version of every probe variant in the kernels' order: the
    n / 128 column tiles cut into ``split`` parts of ceil(tiles / split)
    tiles (the last ones short or empty), each part's 128-column sums
    folded in order, and the part sums folded in rank order.  Arguments
    and results as ``reference``'s."""
    px, py, mag = _tile_sums(variant, tensors, tile_i, tile_j, TILE,
                             magnitudes)
    per = -(-px.shape[1] // split)
    parts = [_fold(px[:, p:p + per], py[:, p:p + per])
             for p in range(0, split * per, per)]
    ax, ay = parts[0]
    for vx, vy in parts[1:]:
        ax = ax + vx
        ay = ay + vy
    return _finish(ax, ay, tensors[2], mag, magnitudes)


def launch(name, fn_name, variant_index, tensors, tile_i, tile_j):
    """Launch the probe kernel ``fn_name`` of the probes library on the
    device's current stream into fresh outputs (never aliased with an
    input); raise if the launch was refused."""
    lib = _build.load("probes")
    dev = tensors[0].device
    xf = torch.empty_like(tensors[0])
    yf = torch.empty_like(tensors[0])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib.cdll, fn_name)(
            variant_index, *(t.data_ptr() for t in tensors),
            tensors[0].shape[0], tile_i, tile_j, xf.data_ptr(),
            yf.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("%s: kernel launch failed: %s (%d)"
                           % (name, lib.error_string(err), err))
    return xf, yf


def inputs(n, device):
    """The probes' eight fp32 vectors (xi, yi, mi, ri, xj, yj, mj, rj),
    uniform in [1, 2), from a generator on ``device`` seeded with 0."""
    gen = torch.Generator(device=device).manual_seed(0)
    return tuple(torch.empty(n, dtype=torch.float32, device=device)
                 .uniform_(1.0, 2.0, generator=gen) for _ in range(8))


def bench(forces, variant, n, steps, tile_i, tile_j, repeats):
    """Seconds per call of ``forces`` (a probe's ``probe_forces``): one
    warm run of ``steps`` calls whose outputs feed back as xi and yi, then
    ``repeats`` timed runs, each ending in ``torch.cuda.synchronize()``;
    the best is returned.  Raises without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes measure only on a CUDA device, and "
                           "none is available")
    args = inputs(n, torch.device("cuda", torch.cuda.current_device()))

    def many():
        a = args
        for _ in range(steps):
            xf, yf = forces(variant, *a, tile_i=tile_i, tile_j=tile_j)
            a = (xf, yf) + a[2:]

    many()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        many()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / steps)
    return best


def device_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return smi.stdout.strip().splitlines()[
            torch.cuda.current_device()]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "%s, power.limit not read" % torch.cuda.get_device_name()


def parse_argv(argv, defaults):
    """The probes' positional integers, with the JAX probes' defaults."""
    return [int(argv[k + 1]) if len(argv) > k + 1 else d
            for k, d in enumerate(defaults)]
