"""The hand-written CUDA force kernel: wrapper, plain version and dispatch.

Counterpart of ``parallel_nbody_tpu/ops/pallas_step.py``.  ``block_forces``
computes the one-sided force of column block J on row block I, exactly what
the Pallas ``_force_kernel`` computes (see csrc/forces.cu for the kernel and
its design):

    acc_i = sum_j m_j * rsqrt(forced^2 * dsqr + eps) * (dx, dy)
    F_i   = acc_i * (G * m_i),   forced = max(dsqr, (r_i + r_j)^2)

plus, when ``biased``, the reference's atan2(0, 0) kick
``m_j * sign(gj - gi) / forced`` along +x for coincident distinct pairs
(global ids ``row_g0 + i``, ``col_g0 + j``).  ``biased=False`` drops the kick
and is only correct when no two distinct massive bodies coincide —
``forces_coincident_dispatch`` chooses it from ``any_coincident``.

On CUDA tensors ``block_forces`` launches the kernel or raises; on CPU
tensors it runs ``block_forces_reference``, the plain PyTorch version of the
same arithmetic.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from . import _build

# De-NaN floor inside the rsqrt (pallas_step.py::_EPS / _EPS64): it keeps
# self-pairs and coincident pairs at 0 * finite instead of 0 * inf.  Real
# pairs have forced^2 * dsqr >= 16 * dsqr, far above it.
_EPS = {torch.float32: 1e-36, torch.float64: 1e-200}
# Denominator floor of the kick (forces.py::_DENOM_FLOOR): only zero-radius
# padding pairs have forced < 4.
_DENOM_FLOOR = 1e-30
# Elements per (rows, K) intermediate of the plain version: 16M elements is
# 64 MiB in fp32, so N=65536 fits on the card 256 rows at a time.
_CHUNK_ELEMS = 1 << 24


def _flag_factor(biased, dtype):
    """None for ``biased=False``; else a multiplier for the kick (1.0, or the
    device-side flag as a 0-d tensor of ``dtype``)."""
    if isinstance(biased, torch.Tensor):
        return biased.to(dtype)
    return 1.0 if biased else None


def block_forces_reference(cfg: SimConfig, xi, yi, mi, ri, xj, yj, mj, rj,
                           *, row_g0: int = 0, col_g0: int = 0, biased):
    """Plain PyTorch version of the kernel, chunked over rows so the (rows,
    K) intermediates stay bounded on any device.  ``biased`` is a bool or a
    0-d bool tensor (read without a host sync)."""
    dtype = xi.dtype
    eps = _EPS[dtype]
    m, k = xi.shape[0], xj.shape[0]
    flag = _flag_factor(biased, dtype)
    gj = col_g0 + torch.arange(k, device=xj.device)
    zero = torch.zeros((), dtype=dtype, device=xi.device)
    chunk = max(1, _CHUNK_ELEMS // max(k, 1))
    xs, ys = [], []
    for r0 in range(0, m, chunk):
        rows = slice(r0, min(m, r0 + chunk))
        dx = xj[None, :] - xi[rows, None]
        dy = yj[None, :] - yi[rows, None]
        dsqr = dx * dx + dy * dy
        mind = ri[rows, None] + rj[None, :]
        forced = torch.maximum(dsqr, mind * mind)
        s = mj[None, :] * torch.rsqrt(forced * forced * dsqr + eps)
        ax = torch.sum(s * dx, dim=1)
        ay = torch.sum(s * dy, dim=1)
        if flag is not None:
            gi = row_g0 + torch.arange(r0, rows.stop, device=xi.device)
            sgn = torch.sign(gj[None, :] - gi[:, None]).to(dtype)
            kick = torch.where(dsqr == 0, mj[None, :] * sgn
                               / torch.clamp_min(forced, _DENOM_FLOOR), zero)
            ax = ax + torch.sum(kick, dim=1) * flag
        gmi = mi[rows] * cfg.gravity
        xs.append(ax * gmi)
        ys.append(ay * gmi)
    if not xs:
        return torch.empty_like(xi), torch.empty_like(yi)
    return torch.cat(xs), torch.cat(ys)


def _check_inputs(rows, cols, biased):
    """Raise on what the kernel does not take: mixed devices or dtypes, a
    dtype other than fp32/fp64, non-1-D or non-contiguous tensors, ragged
    blocks, or a flag that is not a 0-d bool tensor on the same device."""
    ref = rows[0]
    for t in rows + cols:
        if t.device != ref.device:
            raise ValueError("block_forces: tensors on %s and %s"
                             % (ref.device, t.device))
        if t.dtype != ref.dtype:
            raise TypeError("block_forces: dtypes %s and %s"
                            % (ref.dtype, t.dtype))
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError("block_forces: expected contiguous 1-D tensors, "
                             "got shape %s" % (tuple(t.shape),))
    if ref.dtype not in _EPS:
        raise TypeError("block_forces: dtype %s (expected float32 or float64)"
                        % ref.dtype)
    if {t.shape[0] for t in rows} != {rows[0].shape[0]} or \
            {t.shape[0] for t in cols} != {cols[0].shape[0]}:
        raise ValueError("block_forces: ragged row or column block")
    if isinstance(biased, torch.Tensor) and (
            biased.dtype != torch.bool or biased.dim() != 0
            or biased.device != ref.device):
        raise ValueError("block_forces: biased flag must be a 0-d bool "
                         "tensor on %s" % ref.device)


def block_forces(cfg: SimConfig, xi, yi, mi, ri, xj, yj, mj, rj, *,
                 row_g0: int = 0, col_g0: int = 0, biased):
    """Force of every body of block J on every body of block I.

    ``biased`` is a bool, or a 0-d bool tensor that the kernel reads from
    device memory (no host sync).  Returns (xf, yf) of shape (M,).  Each
    launch of the CUDA kernel adds one to ``block_forces.launches``.
    """
    rows, cols = (xi, yi, mi, ri), (xj, yj, mj, rj)
    _check_inputs(rows, cols, biased)
    if xi.device.type == "cpu":
        return block_forces_reference(cfg, *rows, *cols, row_g0=row_g0,
                                      col_g0=col_g0, biased=biased)
    if xi.device.type != "cuda":
        raise ValueError("block_forces: unsupported device %s" % xi.device)
    m, k = xi.shape[0], xj.shape[0]
    xf = torch.empty_like(xi)
    yf = torch.empty_like(xi)
    if m == 0:
        return xf, yf
    lib = _build.load()
    fn = (lib.cdll.nbody_block_forces_f32 if xi.dtype == torch.float32
          else lib.cdll.nbody_block_forces_f64)
    if isinstance(biased, torch.Tensor):
        flag_ptr, flag_default = biased.data_ptr(), 0
    else:
        flag_ptr, flag_default = None, int(bool(biased))
    with torch.cuda.device(xi.device):
        stream = torch.cuda.current_stream(xi.device).cuda_stream
        err = fn(*(t.data_ptr() for t in rows), m,
                 *(t.data_ptr() for t in cols), k, int(row_g0), int(col_g0),
                 float(cfg.gravity), flag_ptr, flag_default,
                 xf.data_ptr(), yf.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("block_forces: kernel launch failed: %s (%d)"
                           % (lib.error_string(err), err))
    block_forces.launches += 1
    return xf, yf


block_forces.launches = 0


def cuda_forces(cfg: SimConfig, x, y, mass, radius, *, biased):
    """Total pairwise forces (square case) through ``block_forces``."""
    return block_forces(cfg, x, y, mass, radius, x, y, mass, radius,
                        biased=biased)


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
    perm = torch.arange(x.shape[0], device=x.device)
    for key in reversed(keys):  # least significant key first
        _, idx = torch.sort(key[perm], stable=True)
        perm = perm[idx]
    xs, ys, ms = (key[perm] for key in keys)
    dup = (xs[1:] == xs[:-1]) & (ys[1:] == ys[:-1]) & (ms[:-1] > 0)
    return torch.any(dup)


def forces_coincident_dispatch(x, y, mass, call):
    """Run ``call(biased)`` — which must close over its inputs and return
    (xf, yf) — with ``biased`` the device-side ``any_coincident`` flag: the
    kernel adds the coincident kick only where the flag is set, in place of
    the JAX package's ``lax.cond`` between two kernels."""
    return call(any_coincident(x, y, mass))
