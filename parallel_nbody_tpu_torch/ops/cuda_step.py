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

- ``block_forces`` (K1, csrc/forces.cu; Pallas ``_force_kernel``) sums each
  row over all columns in 128-wide tiles.
- ``block_forces_streamed`` (K2, csrc/forces_streamed.cu; Pallas
  ``_force_kernel_streamed``) sums each row band by band (``band`` columns,
  65536 by default) and folds the band partials in band order.

``accum="compensated"`` Kahan-folds each tile's partial into the row sum and,
in K2, each band partial into the total; a band's own compensation term is
dropped at band end (``pallas_step._acc_finish``).  bfloat16 is a storage
format: inputs upcast to float32, every sum stays float32, and the result is
rounded to bfloat16 once (``pallas_step._compute_dtype``).

``cuda_forces`` and ``block_forces_auto`` dispatch as ``pallas_forces`` and
``pallas_block_forces_auto`` do: K2 above ``STREAMED_ABOVE`` bodies.  On the
H100 that threshold is no memory limit (K1 streams its column tiles from
device memory at any N); it is kept so that the port sums in the same
structure as the JAX package at every N.  K2's workspace of band partials
grows with rows x N, so ``cuda_forces`` runs K2 in row launches that keep it
within ``K2_WORKSPACE_BYTES`` (``streamed_forces``).

On CUDA tensors each wrapper launches its kernel or raises; on CPU tensors
it runs its plain PyTorch version (``block_forces_reference``,
``block_forces_streamed_reference``).
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from . import _build

# pallas_step._VMEM_RESIDENT_LIMIT and pallas_block_forces_streamed's band.
STREAMED_ABOVE = 1 << 17
STREAM_BAND = 65536
# The kernels' j-tile (kBlock in csrc/pairs.cuh).
TILE = 128
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


def _launch(name, stem, dtype, device, *args):
    """Call the C launcher ``stem`` for storage ``dtype`` on the device's
    current stream; raise if the launch was refused."""
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fn(stem, _SUFFIX[dtype])(*args, stream)
    if err != 0:
        raise RuntimeError("%s: kernel launch failed: %s (%d)"
                           % (name, lib.error_string(err), err))


def block_forces(cfg: SimConfig, xi, yi, mi, ri, xj, yj, mj, rj, *,
                 row_g0: int = 0, col_g0: int = 0, biased,
                 accum: str = "plain"):
    """K1: force of every body of block J on every body of block I.

    ``biased`` is a bool, or a 0-d bool tensor that the kernel reads from
    device memory (no host sync).  Returns (xf, yf) of shape (M,) in the
    inputs' dtype.  Each launch of the CUDA kernel adds one to
    ``block_forces.launches``.
    """
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
    block_forces.launches += 1
    return xf, yf


block_forces.launches = 0


def band_fold(cfg: SimConfig, ws, mi, *, accum: str = "plain"):
    """K2's second launch on its own: fold the (bands, 2, M) band partials
    ``ws`` in band order and apply ``G * m_i``.  Returns (xf, yf) in
    ``mi``'s dtype.  (``block_forces_streamed`` calls it; it has no count of
    its own.)"""
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


def cuda_forces(cfg: SimConfig, x, y, mass, radius, *, biased,
                accum: str = "plain"):
    """Total pairwise forces (square case), as ``pallas_forces`` computes
    them: K2 with band ``STREAM_BAND`` above ``STREAMED_ABOVE`` bodies, in
    row launches (``streamed_forces``), K1 otherwise."""
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
    the JAX package's ``lax.cond`` between two kernels."""
    return call(any_coincident(x, y, mass))
