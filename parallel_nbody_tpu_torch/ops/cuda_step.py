"""The hand-written CUDA force kernels: wrappers, plain versions and dispatch.

Counterpart of ``parallel_nbody_tpu/ops/pallas_step.py``.  Both kernels
compute the one-sided force of column block J on row block I (see csrc/ for
the kernels and their design):

    acc_i = sum_j m_j * rsqrt(forced^2 * dsqr + eps) * (dx, dy)
    F_i   = acc_i * (G * m_i),   forced = max(dsqr, (r_i + r_j)^2)

plus, when ``biased``, the reference's atan2(0, 0) kick
``m_j * sign(gj - gi) / forced`` along +x for coincident distinct pairs
(global ids ``row_g0 + i``, ``col_g0 + j``), through the TPU kernel's dx
bias segmented by tile (``pallas_step.py:26-46``): ``dx = (xj - xi) + b``
with ``b = -C`` on column tiles wholly below the row block, ``+C`` wholly
above it and ``(gj - gi) * P`` on tiles that overlap it, so a coincident
pair's term is the kick and a self-pair's is 0.  The kernels' geometry is
128-row blocks against 128-wide column tiles; the plain versions take it as
``row_block`` and ``tile``, so they also run at Pallas's 1024/1024.
``biased=False`` drops the bias and is only correct when no two distinct
massive bodies coincide — ``forces_coincident_dispatch`` chooses it from
``any_coincident``.

- ``block_forces`` (K1, csrc/forces.cu, ``block_forces_one_sided``; Pallas
  ``_force_kernel``) sums each row over all columns in 128-wide tiles.
  Where the call shows one block of bodies against itself (equal lengths at
  equal offsets, to ``STREAMED_ABOVE`` bodies) in float32 with plain sums
  (``takes_symmetric``), it launches csrc/forces_symmetric.cu instead, which evaluates each
  unordered pair once and applies it to both bodies, in the order that
  ``symmetric_partials`` writes down, then folds with K2's ``band_fold``.
- ``block_forces_streamed`` (K2, csrc/forces_streamed.cu; Pallas
  ``_force_kernel_streamed``) sums each row band by band (``band`` columns,
  65536 by default) and folds the band partials in band order.

``accum="compensated"`` Kahan-folds each tile's partial into the row sum and,
in K2, each band partial into the total; a band's own compensation term is
dropped at band end (``pallas_step._acc_finish``).  bfloat16 is a storage
format: inputs upcast to float32, every sum stays float32, and the result is
rounded to bfloat16 once (``pallas_step._compute_dtype``).

- ``trig_forces`` (the parity pass, csrc/forces_trig.cu; no Pallas
  counterpart) is ``force_mode="trig"`` in float64: the reference's
  transcendental pair math, each body's terms added one at a time in
  ascending partner order, bit for bit ``ops.forces.compute_forces_dense``'s
  trig path.  The kick of a coincident pair is atan2(0, 0)'s own, so it
  takes no flag.

``cuda_forces`` and ``block_forces_auto`` dispatch as ``pallas_forces`` and
``pallas_block_forces_auto`` do: K2 above ``STREAMED_ABOVE`` bodies.  On the
H100 that threshold is no memory limit (K1 streams its column tiles from
device memory at any N); it is kept so that the port sums in the same
structure as the JAX package at every N.  K2's workspace of band partials
grows with rows x N, so ``cuda_forces`` runs K2 in row launches that keep it
within ``K2_WORKSPACE_BYTES`` (``streamed_forces``).

On CUDA tensors each wrapper launches its kernel or raises; on CPU tensors
it runs its plain PyTorch version (``block_forces_reference``,
``block_forces_streamed_reference``, ``trig_forces_reference``).
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..utils.timing import span
from . import _build
from .forces import _DENOM_FLOOR, pair_forces_trig

# pallas_step._VMEM_RESIDENT_LIMIT and pallas_block_forces_streamed's band.
STREAMED_ABOVE = 1 << 17
STREAM_BAND = 65536
# The kernels' j-tile (kBlock in csrc/pairs.cuh).
TILE = 128
# Bodies per tile of the symmetric kernel (kTile in csrc/forces_symmetric.cu,
# which refuses a launch with another value).
SYMMETRIC_TILE = 512
ACCUMS = ("plain", "compensated")

# Storage dtype -> compute dtype.
_COMPUTE = {torch.bfloat16: torch.float32, torch.float32: torch.float32,
            torch.float64: torch.float64}
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32",
           torch.float64: "f64"}
# De-NaN floor inside the rsqrt (pallas_step.py::_EPS / _EPS64): it keeps
# self-pairs at 0 * finite instead of 0 * inf.  Real pairs have
# forced^2 * dsqr >= 16 * dsqr, far above it.
_EPS = {torch.float32: 1e-36, torch.float64: 1e-200}
# The dx bias (pallas_step.py:90-93) by compute dtype: the constant C of
# column tiles wholly below or above the row block and the per-pair scale P
# of overlapping tiles, powers of two so that (gj - gi) * P is exact.
_BIAS = {torch.float32: (2.0 ** -26, 2.0 ** -50),
         torch.float64: (2.0 ** -40, 2.0 ** -80)}
# Elements per (rows, K) intermediate of the plain versions: 16M elements is
# 64 MiB in fp32, so N=65536 fits on the card 256 rows at a time.
_CHUNK_ELEMS = 1 << 24
# The band kernel's grid puts the bands on its y axis.
_MAX_BANDS = 65535
# The most bytes of band partials that ``streamed_forces`` lets one K2 launch
# keep: 1 GiB holds one launch over all rows up to N=2.9M in fp32 and
# N=2**21 in fp64; past that the rows go in several launches.
K2_WORKSPACE_BYTES = 1 << 30
# Elements per (rows, columns) intermediate of the parity pass's plain
# version: 16 MiB in fp64.
_TRIG_CHUNK_ELEMS = 1 << 21
# Elements per torch.atan2 call of that plain version on the CPU: a whole
# number of vectors at every width, and below the 32768 elements at which
# ATen splits an elementwise loop over threads.  This and ``_TRIG_TINY``
# follow ATen's CPU loops as torch 2.13 (CPU build) has them on an AVX-512
# Xeon, where they were measured; another torch or vector width may move
# them, which tests/test_torch_trig.py's bit-equality tests then show.  The
# card's path does not read them.
_ATAN2_CALL = 1 << 14
# Below this many bodies the plain version takes its pair values from the
# dense path's own (N, N) call (see ``trig_forces_reference``).
_TRIG_TINY = 16


def _flag(biased):
    """None for ``biased=False``; else True, or the device-side 0-d bool
    flag tensor."""
    if isinstance(biased, torch.Tensor):
        return biased
    return True if biased else None


def band_width(k: int, band: int, tile: int = TILE) -> int:
    """The band K2 really uses for ``k`` columns: at most ``k`` rounded up
    to a tile, at least one tile, and a whole number of tiles
    (pallas_step.py:434-435)."""
    band = max(tile, min(band, -(-k // tile) * tile))
    return band - band % tile


def _kahan_add(acc, comp, val):
    """pallas_step._kahan_add: fold ``val`` into ``acc``, carrying the
    rounding error in ``comp``."""
    y = val - comp
    t = acc + y
    return t, (t - acc) - y


def dx_bias(rows: range, k: int, *, row_g0: int, col_g0: int,
            row_block: int, tile: int, dtype, device=None):
    """The segmented dx bias of rows ``rows`` (block-local) against columns
    0..k-1 of the column block, as a (len(rows), k) tensor of ``dtype``:
    ``-C`` where the column's ``tile``-wide tile lies wholly below the row's
    ``row_block``-row block (every global column id below every row id),
    ``+C`` wholly above, ``(gj - gi) * P`` where they overlap."""
    cbias, pbias = _BIAS[dtype]
    i = torch.arange(rows.start, rows.stop, device=device)[:, None]
    j = torch.arange(k, device=device)[None, :]
    gi0 = row_g0 + i - i % row_block  # first row of the row's block
    gj0 = col_g0 + j - j % tile  # first column of the column's tile
    per_pair = ((col_g0 + j) - (row_g0 + i)).to(dtype) * pbias
    const = torch.where(gj0 < gi0, -cbias, cbias).to(dtype)
    overlap = (gj0 + tile > gi0) & (gj0 < gi0 + row_block)
    return torch.where(overlap, per_pair, const)


def _tile_partials(xi, yi, ri, xj, yj, mj, rj, *, row_g0, col_g0, flag,
                   tile, row_block):
    """Per-tile partial sums of each row's raw acceleration (before
    G * m_i): two (M, ceil(K / tile)) tensors in the inputs' dtype.  Rows
    are chunked so the (rows, K) intermediates stay bounded on any
    device."""
    dtype, dev = xi.dtype, xi.device
    eps = _EPS[dtype]
    m, k = xi.shape[0], xj.shape[0]
    nt = -(-k // tile)
    px = torch.zeros((m, nt), dtype=dtype, device=dev)
    py = torch.zeros((m, nt), dtype=dtype, device=dev)
    chunk = max(1, _CHUNK_ELEMS // max(k, 1))
    for r0 in range(0, m if k else 0, chunk):
        rows = slice(r0, min(m, r0 + chunk))
        dx = xj[None, :] - xi[rows, None]
        if flag is not None:
            biased = dx + dx_bias(range(rows.start, rows.stop), k,
                                  row_g0=row_g0, col_g0=col_g0,
                                  row_block=row_block, tile=tile,
                                  dtype=dtype, device=dev)
            dx = biased if flag is True else torch.where(flag, biased, dx)
        dy = yj[None, :] - yi[rows, None]
        dsqr = dx * dx + dy * dy
        mind = ri[rows, None] + rj[None, :]
        forced = torch.maximum(dsqr, mind * mind)
        s = mj[None, :] * torch.rsqrt(forced * forced * dsqr + eps)
        fx, fy = s * dx, s * dy
        pad = (0, nt * tile - k)
        px[rows] = torch.nn.functional.pad(fx, pad).view(-1, nt, tile).sum(2)
        py[rows] = torch.nn.functional.pad(fy, pad).view(-1, nt, tile).sum(2)
    return px, py


def _fold(px, py, accum):
    """Fold the columns of (M, T) partials in order, plainly or with Kahan;
    the compensation term is dropped at the end (pallas_step._acc_finish).
    Returns two (M,) sums."""
    ax = torch.zeros(px.shape[0], dtype=px.dtype, device=px.device)
    ay = torch.zeros_like(ax)
    cx, cy = torch.zeros_like(ax), torch.zeros_like(ax)
    for vx, vy in zip(px.t().contiguous(), py.t().contiguous()):
        if accum == "compensated":
            ax, cx = _kahan_add(ax, cx, vx)
            ay, cy = _kahan_add(ay, cy, vy)
        else:
            ax = ax + vx
            ay = ay + vy
    return ax, ay


def _upcast(tensors):
    return [t.to(_COMPUTE[t.dtype]) for t in tensors]


def block_forces_reference(cfg: SimConfig, xi, yi, mi, ri, xj, yj, mj, rj,
                           *, row_g0: int = 0, col_g0: int = 0, biased,
                           accum: str = "plain", tile: int = TILE,
                           row_block: int = TILE):
    """Plain PyTorch version of K1: each ``tile``-wide slice of a row is
    summed, and the slices are folded in order (with Kahan under
    ``compensated``).  ``biased`` is a bool or a 0-d bool tensor (read
    without a host sync); the bias segments follow ``row_block``-row blocks
    against ``tile``-wide column tiles."""
    store = xi.dtype
    xi, yi, mi, ri, xj, yj, mj, rj = _upcast((xi, yi, mi, ri, xj, yj, mj,
                                              rj))
    px, py = _tile_partials(xi, yi, ri, xj, yj, mj, rj, row_g0=row_g0,
                            col_g0=col_g0, flag=_flag(biased), tile=tile,
                            row_block=row_block)
    ax, ay = _fold(px, py, accum)
    gmi = mi * cfg.gravity
    return (ax * gmi).to(store), (ay * gmi).to(store)


def _tile_sums(terms, tile):
    """(rows, k) pair terms -> (rows, ceil(k / tile)): each ``tile``-wide
    slice of a row summed as the symmetric kernel sums it, each ``TILE``-wide
    block into a partial and the slice's partials added in order."""
    rows, k = terms.shape
    nt = -(-k // tile)
    blocks = torch.nn.functional.pad(terms, (0, nt * tile - k)).view(
        rows, nt, tile // TILE, TILE).sum(3)
    out = blocks[:, :, 0]
    for b in range(1, tile // TILE):
        out = out + blocks[:, :, b]
    return out


def symmetric_partials(x, y, mass, radius, *, biased,
                       tile: int = SYMMETRIC_TILE):
    """The symmetric kernel's workspace in plain PyTorch: (nt, 2, n) raw
    accelerations (before G * m), slot ``[K, :, b]`` body b's sum over the
    bodies of tile K (``tile`` bodies each, the last one ragged).

    One block of bodies against itself, each unordered pair evaluated once:
    for the tile pair (I, J), J > I, the rows i of I get K1's terms
    ``(m_j * w) * dx_ij`` summed over J into slot ``[J, :, i]`` (each
    128-column block into a partial, the partials added in order), and the
    columns j of J the terms ``-(m_i * w) * dx_ij`` (K1's own term for the
    pair (j, i): the segmented bias is antisymmetric, so dx_ji = -dx_ij in
    float) summed over I into slot ``[I, :, j]``.  A diagonal tile (I, I)
    takes K1's one-sided terms of its rows over its own columns into slot
    ``[I, :, i]``, summed the same way.  The bias is K1's: 128-row blocks against 128-wide
    column tiles at equal offsets, so ``tile`` must be a multiple of 128."""
    dtype, dev = x.dtype, x.device
    eps = _EPS[dtype]
    flag = _flag(biased)
    n = x.shape[0]
    nt = -(-n // tile)
    ws = torch.zeros((nt, 2, n), dtype=dtype, device=dev)
    for ti in range(nt):
        r0, r1 = ti * tile, min(n, (ti + 1) * tile)
        rows = slice(r0, r1)
        dx = x[None, r0:] - x[rows, None]
        if flag is not None:
            b = dx + dx_bias(range(r0, r1), n - r0, row_g0=0, col_g0=r0,
                             row_block=TILE, tile=TILE, dtype=dtype,
                             device=dev)
            dx = b if flag is True else torch.where(flag, b, dx)
        dy = y[None, r0:] - y[rows, None]
        dsqr = dx * dx + dy * dy
        mind = radius[rows, None] + radius[None, r0:]
        forced = torch.maximum(dsqr, mind * mind)
        w = torch.rsqrt(forced * forced * dsqr + eps)
        sj = mass[None, r0:] * w
        si = mass[rows, None] * w
        d = r1 - r0  # the diagonal tile's columns come first
        for c, dc in ((0, dx), (1, dy)):
            ws[ti, c, rows] = _tile_sums(sj[:, :d] * dc[:, :d], tile)[:, 0]
            if r1 < n:
                ws[ti + 1:, c, rows] = _tile_sums(sj[:, d:] * dc[:, d:],
                                                  tile).t()
                ws[ti, c, r1:] = (-(si[:, d:] * dc[:, d:])).sum(0)
    return ws


def block_forces_symmetric_reference(cfg: SimConfig, x, y, mass, radius, *,
                                     biased, tile: int = SYMMETRIC_TILE):
    """Plain PyTorch version of the symmetric kernel (one block of bodies
    against itself, fp32 compute, plain sums): ``symmetric_partials``, the
    slots of each body added in tile order 0..nt-1, then ``G * m``."""
    store = x.dtype
    x, y, mass, radius = _upcast((x, y, mass, radius))
    ws = symmetric_partials(x, y, mass, radius, biased=biased, tile=tile)
    ax, ay = _fold(ws[:, 0].t(), ws[:, 1].t(), "plain")
    gm = mass * cfg.gravity
    return (ax * gm).to(store), (ay * gm).to(store)


def block_forces_streamed_reference(cfg: SimConfig, xi, yi, mi, ri, xj, yj,
                                    mj, rj, *, row_g0: int = 0,
                                    col_g0: int = 0,
                                    band: int = STREAM_BAND, biased,
                                    accum: str = "plain", tile: int = TILE,
                                    row_block: int = TILE):
    """Plain PyTorch version of K2: per band, K1's tile partials folded into
    a band partial (the compensation term dropped at band end); then the
    band partials folded in band order (with Kahan under ``compensated``);
    then ``G * m_i``.  A band's bias segments count its tiles from the
    band's start."""
    store = xi.dtype
    xi, yi, mi, ri, xj, yj, mj, rj = _upcast((xi, yi, mi, ri, xj, yj, mj,
                                              rj))
    flag = _flag(biased)
    k = xj.shape[0]
    band = band_width(k, band, tile)
    bx, by = [], []
    for b0 in range(0, k, band):
        cols = slice(b0, min(k, b0 + band))
        px, py = _tile_partials(xi, yi, ri, xj[cols], yj[cols], mj[cols],
                                rj[cols], row_g0=row_g0, col_g0=col_g0 + b0,
                                flag=flag, tile=tile, row_block=row_block)
        fx, fy = _fold(px, py, accum)
        bx.append(fx)
        by.append(fy)
    if bx:
        ax, ay = _fold(torch.stack(bx, 1), torch.stack(by, 1), accum)
    else:
        ax = ay = torch.zeros_like(xi)
    gmi = mi * cfg.gravity
    return (ax * gmi).to(store), (ay * gmi).to(store)


def _check_inputs(name, rows, cols, biased, accum):
    """Raise on what the kernels do not take: mixed devices or dtypes, a
    dtype other than bf16/fp32/fp64, non-1-D or non-contiguous tensors,
    ragged blocks, a flag that is not a 0-d bool tensor on the same device,
    or an unknown accumulation."""
    ref = rows[0]
    for t in rows + cols:
        if t.device != ref.device:
            raise ValueError("%s: tensors on %s and %s"
                             % (name, ref.device, t.device))
        if t.dtype != ref.dtype:
            raise TypeError("%s: dtypes %s and %s"
                            % (name, ref.dtype, t.dtype))
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError("%s: expected contiguous 1-D tensors, got "
                             "shape %s" % (name, tuple(t.shape)))
    if ref.dtype not in _COMPUTE:
        raise TypeError("%s: dtype %s (expected bfloat16, float32 or "
                        "float64)" % (name, ref.dtype))
    if {t.shape[0] for t in rows} != {rows[0].shape[0]} or \
            {t.shape[0] for t in cols} != {cols[0].shape[0]}:
        raise ValueError("%s: ragged row or column block" % name)
    if isinstance(biased, torch.Tensor) and (
            biased.dtype != torch.bool or biased.dim() != 0
            or biased.device != ref.device):
        raise ValueError("%s: biased flag must be a 0-d bool tensor on %s"
                         % (name, ref.device))
    if accum not in ACCUMS:
        raise ValueError("%s: unsupported accum %r (expected plain or "
                         "compensated)" % (name, accum))
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError("%s: unsupported device %s" % (name, ref.device))


def _flag_args(biased):
    """(pointer, default) for the kernels' biased flag."""
    if isinstance(biased, torch.Tensor):
        return biased.data_ptr(), 0
    return None, int(bool(biased))


def _launch(name, stem, dtype, device, *args, library="kernels"):
    """Call the C launcher ``stem`` of the library ``library`` for storage
    ``dtype`` on the device's current stream; raise if the launch was
    refused."""
    lib = _build.load(library)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fn(stem, _SUFFIX[dtype])(*args, stream)
    if err != 0:
        raise RuntimeError("%s: kernel launch failed: %s (%d)"
                           % (name, lib.error_string(err), err))


def takes_symmetric(dtype, m: int, k: int, *, row_g0: int, col_g0: int,
                    accum: str) -> bool:
    """Whether ``block_forces`` on a card takes the symmetric pass for an
    (m, k) block pair of storage ``dtype``: the compute type is float32 (fp32
    or bf16 storage), the sum is plain, and the call is one block of bodies
    against itself, which it shows as ``m == k`` and ``row_g0 == col_g0``
    (global ids name bodies in every program, so equal offsets and lengths
    are the same bodies).  Only to ``STREAMED_ABOVE`` bodies, K1's range:
    the (tiles, 2, m) fp32 workspace grows as m**2 / 64 bytes, 256 MiB
    there, within K2's ``K2_WORKSPACE_BYTES``, and 16 GiB at 1M bodies."""
    return (_COMPUTE.get(dtype) == torch.float32 and accum == "plain"
            and m == k and row_g0 == col_g0 and m <= STREAMED_ABOVE)


def block_forces(cfg: SimConfig, xi, yi, mi, ri, xj, yj, mj, rj, *,
                 row_g0: int = 0, col_g0: int = 0, biased,
                 accum: str = "plain"):
    """Force of every body of block J on every body of block I.

    ``biased`` is a bool, or a 0-d bool tensor that the kernel reads from
    device memory (no host sync).  Returns (xf, yf) of shape (M,) in the
    inputs' dtype.  Where ``takes_symmetric`` holds on the card, the pass is
    the symmetric kernel into a (nt, 2, M) fp32 workspace and its fold
    (``band_fold``), and adds one to ``block_forces.symmetric_launches``;
    otherwise it is K1 (``block_forces_one_sided``).  Each pass on the card
    adds one to ``block_forces.launches``.  On the CPU it is K1's plain
    version.  Rows and columns at equal offsets and lengths must be the same
    bodies: the symmetric pass reads only the rows.
    """
    m, k = xi.shape[0], xj.shape[0]
    if xi.device.type != "cuda" or m == 0 or not takes_symmetric(
            xi.dtype, m, k, row_g0=row_g0, col_g0=col_g0, accum=accum):
        out = block_forces_one_sided(cfg, xi, yi, mi, ri, xj, yj, mj, rj,
                                     row_g0=row_g0, col_g0=col_g0,
                                     biased=biased, accum=accum)
        if xi.device.type == "cuda" and m:
            block_forces.launches += 1
        return out
    rows = (xi, yi, mi, ri)
    _check_inputs("block_forces", rows, (xj, yj, mj, rj), biased, accum)
    ws = torch.empty((-(-m // SYMMETRIC_TILE), 2, m), dtype=torch.float32,
                     device=xi.device)
    _launch("block_forces", "nbody_block_forces_symmetric", xi.dtype,
            xi.device, *(t.data_ptr() for t in rows), m, SYMMETRIC_TILE,
            *_flag_args(biased), ws.data_ptr())
    out = band_fold(cfg, ws, mi)
    block_forces.launches += 1
    block_forces.symmetric_launches += 1
    return out


def block_forces_one_sided(cfg: SimConfig, xi, yi, mi, ri, xj, yj, mj, rj,
                           *, row_g0: int = 0, col_g0: int = 0, biased,
                           accum: str = "plain"):
    """K1 (csrc/forces.cu): each row summed over all columns in 128-wide
    tiles, whatever the blocks; ``block_forces`` takes it wherever the
    symmetric pass does not apply.  Called directly it counts nothing."""
    rows, cols = (xi, yi, mi, ri), (xj, yj, mj, rj)
    _check_inputs("block_forces", rows, cols, biased, accum)
    if xi.device.type == "cpu":
        return block_forces_reference(cfg, *rows, *cols, row_g0=row_g0,
                                      col_g0=col_g0, biased=biased,
                                      accum=accum)
    m, k = xi.shape[0], xj.shape[0]
    xf = torch.empty_like(xi)
    yf = torch.empty_like(xi)
    if m == 0:
        return xf, yf
    _launch("block_forces", "nbody_block_forces", xi.dtype, xi.device,
            *(t.data_ptr() for t in rows), m,
            *(t.data_ptr() for t in cols), k, int(row_g0), int(col_g0),
            float(cfg.gravity), *_flag_args(biased),
            int(accum == "compensated"), xf.data_ptr(), yf.data_ptr())
    return xf, yf


block_forces.launches = 0
block_forces.symmetric_launches = 0


def band_fold(cfg: SimConfig, ws, mi, *, accum: str = "plain"):
    """K2's second launch on its own: fold the (bands, 2, M) band partials
    ``ws`` in band order and apply ``G * m_i``.  Returns (xf, yf) in
    ``mi``'s dtype.  (``block_forces_streamed`` and the symmetric pass of
    ``block_forces``, whose tile slots it folds in tile order, call it; it
    has no count of its own.)"""
    nb, _, m = ws.shape
    xf = torch.empty_like(mi)
    yf = torch.empty_like(mi)
    _launch("band_fold", "nbody_band_fold", mi.dtype, mi.device,
            ws.data_ptr(), nb, m, mi.data_ptr(),
            float(cfg.gravity), int(accum == "compensated"), xf.data_ptr(),
            yf.data_ptr())
    return xf, yf


def block_forces_streamed(cfg: SimConfig, xi, yi, mi, ri, xj, yj, mj, rj, *,
                          row_g0: int = 0, col_g0: int = 0,
                          band: int = STREAM_BAND, biased,
                          accum: str = "plain"):
    """K2: ``block_forces`` summed band by band (``band`` columns, rounded
    as ``band_width`` says), the band partials folded in band order.

    Two launches (band partials into a (bands, 2, M) workspace, then
    ``band_fold``) count as one in ``block_forces_streamed.launches``.
    """
    rows, cols = (xi, yi, mi, ri), (xj, yj, mj, rj)
    _check_inputs("block_forces_streamed", rows, cols, biased, accum)
    if xi.device.type == "cpu":
        return block_forces_streamed_reference(
            cfg, *rows, *cols, row_g0=row_g0, col_g0=col_g0, band=band,
            biased=biased, accum=accum)
    m, k = xi.shape[0], xj.shape[0]
    if m == 0:
        return torch.empty_like(xi), torch.empty_like(xi)
    band = band_width(k, int(band))
    nb = max(1, -(-k // band))
    if nb > _MAX_BANDS:
        raise ValueError("block_forces_streamed: %d bands of %d exceed the "
                         "grid's %d" % (nb, band, _MAX_BANDS))
    ws = torch.empty((nb, 2, m), dtype=_COMPUTE[xi.dtype], device=xi.device)
    _launch("block_forces_streamed", "nbody_band_partials", xi.dtype,
            xi.device, xi.data_ptr(), yi.data_ptr(), ri.data_ptr(), m,
            *(t.data_ptr() for t in cols), k, band, int(row_g0), int(col_g0),
            *_flag_args(biased), int(accum == "compensated"), ws.data_ptr())
    out = band_fold(cfg, ws, mi, accum=accum)
    block_forces_streamed.launches += 1
    return out


block_forces_streamed.launches = 0


def block_forces_auto(cfg: SimConfig, xi, yi, mi, ri, xj, yj, mj, rj, *,
                      row_g0: int = 0, col_g0: int = 0, biased,
                      accum: str = "plain"):
    """K1 or K2 by block size, as ``pallas_block_forces_auto`` chooses: K2
    when either block holds more than ``STREAMED_ABOVE`` bodies."""
    fn = (block_forces_streamed
          if max(xi.shape[0], xj.shape[0]) > STREAMED_ABOVE else block_forces)
    return fn(cfg, xi, yi, mi, ri, xj, yj, mj, rj, row_g0=row_g0,
              col_g0=col_g0, biased=biased, accum=accum)


def streamed_rows(k: int, dtype) -> int:
    """The rows of one K2 launch against ``k`` columns that
    ``streamed_forces`` takes by default: as many as keep the (bands, 2,
    rows) workspace of band partials within ``K2_WORKSPACE_BYTES``, a
    multiple of ``TILE`` and at least one tile."""
    bands = -(-k // band_width(k, STREAM_BAND))
    per_row = bands * 2 * _COMPUTE[dtype].itemsize
    return max(TILE, K2_WORKSPACE_BYTES // per_row // TILE * TILE)


def streamed_forces(cfg: SimConfig, x, y, mass, radius, *, biased,
                    accum: str = "plain", row_chunk: int | None = None,
                    fence=None):
    """Total pairwise forces (square case) through K2, the rows in launches
    of ``row_chunk`` (None: ``streamed_rows``; the last launch takes the
    rest), each against all columns at its global offset ``row_g0``.

    The chunks bound K2's workspace: over all N rows at once it is about
    N**2 / 8192 bytes in fp32, 89 GB at N=27M, past the H100's 85 GB of
    device memory.  Each row
    sums its columns band by band in an order that does not depend on the
    rows that share its launch, so chunks that start at multiples of
    ``TILE`` (which keeps the bias segments' row blocks) give one launch's
    forces bit for bit.  ``fence(xf)`` is called after each launch when
    given."""
    n = x.shape[0]
    cols = (x, y, mass, radius)
    step = row_chunk or streamed_rows(n, x.dtype)
    fxs, fys = [], []
    for r0 in range(0, n, step):
        fx, fy = block_forces_streamed(cfg, *(t[r0:r0 + step] for t in cols),
                                       *cols, row_g0=r0, biased=biased,
                                       accum=accum)
        if fence is not None:
            fence(fx)
        fxs.append(fx)
        fys.append(fy)
    if len(fxs) == 1:
        return fxs[0], fys[0]
    return torch.cat(fxs), torch.cat(fys)


def _atan2_vectorised(dy, dx):
    """``torch.atan2(dy, dx)`` with every element through ATen's vectorised
    CPU loop (SLEEF's atan2): flat calls of ``_ATAN2_CALL`` elements, the
    last one padded, so that no call splits over threads or leaves a tail
    to the scalar loop, whose glibc atan2 rounds some arguments otherwise.
    The value of an element then depends on its arguments alone, not on
    where a call puts it.  On other devices, ``torch.atan2`` (the card's
    elementwise kernel already computes every element alike)."""
    if dy.device.type != "cpu":
        return torch.atan2(dy, dx)
    fy, fx = dy.reshape(-1), dx.reshape(-1)
    out = torch.empty_like(fy)
    for s in range(0, fy.numel(), _ATAN2_CALL):
        a, b = fy[s:s + _ATAN2_CALL], fx[s:s + _ATAN2_CALL]
        k = a.numel()
        if k < _ATAN2_CALL:
            pad = (0, _ATAN2_CALL - k)
            a = torch.nn.functional.pad(a, pad)
            b = torch.nn.functional.pad(b, pad, value=1.0)
        out[s:s + k] = torch.atan2(a, b)[:k]
    return out.view(dy.shape)


def _trig_terms(cfg: SimConfig, x, y, mass, radius, c0: int, c1: int):
    """The terms of every body's sum from the bodies ``c0 .. c1 - 1``: two
    (N, c1 - c0) tensors, ``[k, j - c0]`` holding pair(k, j) for j > k,
    -pair(j, k) for j < k and 0 for j == k, each pair in the reference's
    roles (the lower index first: ``dx = x[hi] - x[lo]``), one evaluation
    per ordered pair as the kernel makes it."""
    n = x.shape[0]
    k = torch.arange(n, device=x.device)[:, None]
    j = torch.arange(c0, c1, device=x.device)[None, :]
    upper = j > k
    xr, yr, xc, yc = x[:, None], y[:, None], x[None, c0:c1], y[None, c0:c1]
    dx = torch.where(upper, xc - xr, xr - xc)
    dy = torch.where(upper, yc - yr, yr - yc)
    angle = _atan2_vectorised(dy, dx)
    dsqr = dx * dx + dy * dy
    mind = radius[:, None] + radius[None, c0:c1]
    forced = torch.clamp_min(torch.maximum(dsqr, mind * mind), _DENOM_FLOOR)
    force = mass[:, None] * mass[None, c0:c1] * cfg.gravity / forced
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    out = []
    for t in (force * torch.cos(angle), force * torch.sin(angle)):
        out.append(torch.where(j == k, zero, torch.where(upper, t, -t)))
    return out


def trig_forces_reference(cfg: SimConfig, x, y, mass, radius):
    """Plain PyTorch version of the parity pass (float64): every body's sum
    from +0, one term at a time in ascending partner order, the terms of
    ``_trig_terms`` in column chunks.  Adding the chunk's 0 at a body's own
    slot changes no bit: a sum that starts at +0 never becomes -0.

    It is ``ops.forces.compute_forces_dense``'s trig path bit for bit
    wherever the two evaluate each pair's atan2 alike.  On the card every
    element of an elementwise kernel is.  On the CPU this version sends
    every pair through ATen's vectorised atan2 (``_atan2_vectorised``),
    while the dense path's one (N, N) call leaves its last N*N mod 16
    elements (AVX-512; mod 8 under AVX2) to the scalar loop, and on several
    threads each thread's last few: on one thread those lie in the last
    row, which holds no pair, from N = 16 on.  Below ``_TRIG_TINY`` bodies
    the pair values therefore come from that same (N, N) call
    (``ops.forces.pair_forces_trig``), each term read from it as the dense
    path's signed matrix holds it."""
    n = x.shape[0]
    xf = torch.zeros_like(x)
    yf = torch.zeros_like(x)
    if n < _TRIG_TINY:
        fx, fy = pair_forces_trig(cfg, x, y, mass, radius)
        chunks = [(fx - fx.T, fy - fy.T)]
    else:
        step = max(1, _TRIG_CHUNK_ELEMS // n)
        chunks = (_trig_terms(cfg, x, y, mass, radius, c0, min(n, c0 + step))
                  for c0 in range(0, n, step))
    for tx, ty in chunks:
        for cx, cy in zip(tx.t().contiguous(), ty.t().contiguous()):
            xf += cx
            yf += cy
    return xf, yf


def trig_forces(cfg: SimConfig, x, y, mass, radius):
    """The parity pass: the total force on every body in float64 through
    csrc/forces_trig.cu, bit for bit ``ops.forces.compute_forces_dense``'s
    trig path (the reference's pair math and per-body order).  Each pass on
    the card adds one to ``trig_forces.launches``; on the CPU it is
    ``trig_forces_reference``."""
    state = (x, y, mass, radius)
    _check_inputs("trig_forces", state, state, False, "plain")
    if x.dtype != torch.float64:
        raise TypeError("trig_forces: dtype %s (the parity pass computes "
                        "in float64 only)" % x.dtype)
    if x.device.type == "cpu":
        return trig_forces_reference(cfg, *state)
    n = x.shape[0]
    xf = torch.empty_like(x)
    yf = torch.empty_like(x)
    if n == 0:
        return xf, yf
    _launch("trig_forces", "nbody_trig_forces", x.dtype, x.device,
            *(t.data_ptr() for t in state), n, float(cfg.gravity),
            xf.data_ptr(), yf.data_ptr(), library="trig")
    trig_forces.launches += 1
    return xf, yf


trig_forces.launches = 0


def cuda_forces(cfg: SimConfig, x, y, mass, radius, *, biased,
                accum: str = "plain"):
    """Total pairwise forces (square case), as ``pallas_forces`` computes
    them: K2 with band ``STREAM_BAND`` above ``STREAMED_ABOVE`` bodies, in
    row launches (``streamed_forces``), K1 otherwise.  With
    ``force_mode="trig"`` it is the parity pass (``trig_forces``) at any N,
    which reads neither ``biased`` nor ``accum``."""
    if cfg.force_mode == "trig":
        return trig_forces(cfg, x, y, mass, radius)
    if x.shape[0] > STREAMED_ABOVE:
        return streamed_forces(cfg, x, y, mass, radius, biased=biased,
                               accum=accum)
    return block_forces(cfg, x, y, mass, radius, x, y, mass, radius,
                        biased=biased, accum=accum)


def _lexsort(keys) -> torch.Tensor:
    """The permutation that sorts by ``keys`` lexicographically (the first
    key most significant): stable sorts from the least significant key."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in reversed(keys):
        _, idx = torch.sort(key[perm], stable=True)
        perm = perm[idx]
    return perm


def any_coincident(x, y, mass) -> torch.Tensor:
    """0-d bool tensor: True iff two DISTINCT massive bodies share a position
    exactly (pallas_step.py:535-555).  Computed on the tensors' device and
    returned there, so the caller never waits for it.

    Exact, no false negatives: a stable multi-pass lexicographic sort on
    (x, y, mass) puts equal positions adjacent and groups them by mass, so
    zero-mass padding (all at one far coordinate) never splits or fakes a
    real pair.  Signed zeros are normalized first (``+ 0.0`` maps -0.0 to
    +0.0), since the kernel's dx/dy arithmetic treats them as coincident.
    """
    keys = (x + 0.0, y + 0.0, mass)
    perm = _lexsort(keys)
    xs, ys, ms = (key[perm] for key in keys)
    dup = (xs[1:] == xs[:-1]) & (ys[1:] == ys[:-1]) & (ms[:-1] > 0)
    return torch.any(dup)


def any_coincident_tagged(x, y, mass, gid) -> torch.Tensor:
    """0-d bool tensor: True iff two bodies with DIFFERENT global ids share a
    position and both have mass (pallas_step.py:558-577), on the tensors'
    device.

    For collections that hold several copies of one body — a ring rank's own
    block beside the block visiting it (itself, at hop 0), a grid rank's row
    and col groups, which overlap — where ``any_coincident`` would always
    fire.  Stable sorts on (x, y, gid), the mass carried along, put copies
    of one body next to each other (equal gid, ignored), while a coincident
    pair of distinct bodies shows adjacent entries with differing gids.
    Both masses must be positive: gid, not mass, breaks the ties, so a
    massive body can sort beside a massless one at its position.  Signed
    zeros are normalized as in ``any_coincident``.
    """
    keys = (x + 0.0, y + 0.0, gid)
    perm = _lexsort(keys)
    xs, ys, gs = (key[perm] for key in keys)
    ms = mass[perm]
    dup = ((xs[1:] == xs[:-1]) & (ys[1:] == ys[:-1]) & (gs[1:] != gs[:-1])
           & (ms[:-1] > 0) & (ms[1:] > 0))
    return torch.any(dup)


def forces_coincident_dispatch(x, y, mass, call):
    """Run ``call(biased)`` — which must close over its inputs and return
    (xf, yf) — with ``biased`` the device-side ``any_coincident`` flag: the
    kernel adds the coincident kick only where the flag is set, in place of
    the JAX package's ``lax.cond`` between two kernels.  The flag is the
    span ``nbody.coincident``, the call ``nbody.forces``."""
    with span("nbody.coincident"):
        biased = any_coincident(x, y, mass)
    with span("nbody.forces"):
        return call(biased)
