"""PPM rasterizer on the state's device.

Reference semantics (display, nbody-seq.c:326-354): for every pixel, linear-
scan bodies in index order; the FIRST body whose center is within
``radius + 0.5`` of the pixel wins; its color is a 12-bit tint
``(0xfff * (b+1)) / (bodyCt+2)`` unpacked into RGB nibbles
(color/black, nbody-seq.c:307-324).  O(W*H*N) serial scan.

"First body in index order" == "minimum body index among hits", which
vectorizes as a min-index reduction: the same pixels, computed as a
data-parallel reduction instead of a pixel loop.  These are plain tensor ops
(the JAX package's rasterizer is XLA ops, not a kernel).  Eager ops
materialize every temporary, so ``render_frame`` walks the frame in blocks
of ``row_block`` rows, keeps of the bodies only those near enough to the
block's rows to reach one of them (in index order), and takes these in
chunks of ``body_chunk``, merging the chunks' minima: earlier chunks hold
smaller indices, so an elementwise ``minimum`` preserves first-hit-by-index
exactly and any chunking gives the same bytes.  The (rows, W, bodies) hit
temporaries of one chunk are the only large allocation;
``HIT_BUDGET_BYTES`` bounds them whatever N is.  ``render_frame_hosted``
does the same over the bodies in chunks, each chunk's map over the whole
frame merged by the same minimum, so that the few vectors over all bodies
that the selection keeps cover one chunk.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..utils.timing import span

_NO_HIT = torch.iinfo(torch.int32).max

# The bound on one chunk's (rows, W, bodies) temporaries when ``body_chunk``
# is left to ``render_frame``.
HIT_BUDGET_BYTES = 256 * 2**20


def min_hit_index_rows(x, y, radius, ys, width, base_idx=0):
    """Minimum hitting GLOBAL body index for a block of pixel rows.

    x/y/radius: (B,) body data (padding/disabled bodies must have
    radius < -0.5 so they can never hit).  ys: (R,) row coordinates.
    ``base_idx`` is the global index of body 0 of this chunk.  Returns
    (R, W) int32 (``_NO_HIT`` where nothing hits).

    The distance is computed in the bodies' dtype in the JAX expression's
    order, ``sqrt(dx*dx + dy*dy) <= radius + 0.5``, one rounding per
    operation.
    """
    dtype, device = x.dtype, x.device
    # Laid out (R, W, B), bodies innermost: on a CUDA device the minimum
    # over the outermost axis takes a workspace of 0.7 times its input, over
    # the contiguous axis none.
    px = torch.arange(width, device=device).to(dtype)[None, :, None]
    py = ys.to(dtype)[:, None, None]
    dx = x[None, None, :] - px
    dy = y[None, None, :] - py
    d = (dx * dx + dy * dy).sqrt_()
    hit = d <= (radius[None, None, :] + 0.5)
    del d  # at most two of the three (R, W, B) temporaries are alive at once
    n = x.shape[0]
    bidx = base_idx + torch.arange(n, dtype=torch.int32, device=device)
    return torch.where(hit, bidx, _NO_HIT).amin(dim=-1)


def _chunk_bytes_per_body(row_block: int, width: int,
                          dtype: torch.dtype) -> int:
    """Peak bytes of ``min_hit_index_rows``'s (R, W, 1) temporaries per body:
    the distance with the hit mask, or the hit mask with the int32 index."""
    return row_block * width * (max(dtype.itemsize, 4) + 1)


def tint_rgb(best, n_real: int):
    """12-bit body-index tint unpacked into RGB nibbles
    (nbody-seq.c:307-316); black where nothing hit.  best: (..., ) int
    min-hit indices.  Returns (..., 3) uint8.

    The quotient ``(0xFFF * (b+1)) // (n_real+2)`` is exact int64 division.
    The JAX package, which has no int64 under its fp32 config, corrects an
    fp32 estimate and so cannot go beyond ``n_real + 2 < 2**29``; the same
    input is refused here, so both packages accept the same frames."""
    if n_real + 2 >= 1 << 29:
        raise ValueError(
            "exact 12-bit tint requires n_real + 2 < 2**29 (= %d bodies); "
            "got %d" % ((1 << 29) - 2, n_real))
    miss_mask = best == _NO_HIT
    # Keep the math in range on misses.
    b1 = best.to(torch.int64).masked_fill(miss_mask, 0) + 1
    tint = torch.div(0xFFF * b1, n_real + 2, rounding_mode="floor")
    red = (tint & 0xF) << 4
    green = tint & 0xF0
    blue = (tint & 0xF00) >> 4
    rgb = torch.stack([red, green, blue], dim=-1).to(torch.uint8)
    return rgb.masked_fill(miss_mask[..., None], 0)


def render_frame(cfg: SimConfig, x, y, radius, n_real: int,
                 row_block: int = 32, body_chunk: int | None = None):
    """Rasterize body positions into an (ydim, xdim, 3) uint8 frame on the
    bodies' device.

    Pixel-identical to the reference's display() (modulo sqrt rounding at
    exact hit boundaries).  ``n_real`` masks trailing padding bodies.
    ``body_chunk`` bounds the body axis of the (row_block, W, bodies) hit
    temporaries; left as None it is the largest chunk whose temporaries fit
    ``HIT_BUDGET_BYTES``, so peak memory does not grow with N.  Every
    (row_block, body_chunk) gives the same bytes.  The span
    ``nbody.render``.
    """
    with span("nbody.render"):
        radius = _mask_padding(radius, n_real, 0)
        best = _hit_map(cfg.ydim, cfg.xdim, x, y, radius, row_block,
                        body_chunk)
        return tint_rgb(best, n_real)


def render_frame_hosted(cfg: SimConfig, x, y, radius, n_real: int,
                        body_chunk: int = 262144, fence=None):
    """``render_frame`` over the bodies in chunks of ``body_chunk``, for
    huge N (the counterpart of the JAX package's ``render_frame_hosted``):
    each chunk's min-hit map over the whole frame, in 32-row blocks, is
    merged into the frame's by an elementwise minimum on the device.
    Earlier chunks hold smaller global indices, so the first hit by index
    survives and the pixels are ``render_frame``'s.  Besides the hit
    temporaries (``HIT_BUDGET_BYTES``), ``render_frame`` keeps a few
    vectors over all N bodies to select each block's near bodies; here
    they cover one chunk.  ``fence(sub)`` is called with each chunk's
    (ydim, xdim) map when given.  Returns a host (ydim, xdim, 3) uint8
    array.
    """
    n = x.shape[0]
    h, w = cfg.ydim, cfg.xdim
    best = torch.full((h, w), _NO_HIT, dtype=torch.int32, device=x.device)
    for b0 in range(0, n, body_chunk):
        sl = slice(b0, b0 + body_chunk)
        sub = _hit_map(h, w, x[sl], y[sl],
                       _mask_padding(radius[sl], n_real, b0), 32,
                       base_idx=b0)
        if fence is not None:
            fence(sub)
        torch.minimum(best, sub, out=best)
    return tint_rgb(best, n_real).cpu().numpy()


def _mask_padding(radius, n_real: int, b0: int):
    """``radius`` of the bodies b0, b0+1, ... with those at or past
    ``n_real`` set to -1, which never satisfies d <= r + 0.5."""
    if b0 + radius.shape[0] <= n_real:
        return radius
    gid = b0 + torch.arange(radius.shape[0], device=radius.device)
    return radius.masked_fill(gid >= n_real, -1.0)


def _hit_map(h: int, w: int, x, y, radius, row_block: int,
             body_chunk: int | None = None, base_idx: int = 0):
    """(h, w) int32 map of the minimum GLOBAL index of the bodies that hit
    each pixel (``_NO_HIT`` where none does); body i of x/y/radius has
    index ``base_idx + i``.  Walks the frame in blocks of ``row_block``
    rows, keeps the bodies near enough to reach a row of the block, and
    takes these ``body_chunk`` at a time (None: as many as
    ``HIT_BUDGET_BYTES`` allows)."""
    device = x.device
    if body_chunk is None:
        body_chunk = max(1, HIT_BUDGET_BYTES
                         // _chunk_bytes_per_body(row_block, w, x.dtype))
    best = torch.full((h, w), _NO_HIT, dtype=torch.int32, device=device)
    reach = _reach(y, radius, h)
    y64 = y.double()
    for r0 in range(0, h, row_block):
        rows = best[r0:r0 + row_block]
        r1 = r0 + rows.shape[0] - 1
        ys = torch.arange(r0, r1 + 1, device=device)
        # The bodies that can reach a row of this block, in index order, so
        # the lowest position in ``near`` is the lowest body index.
        near = torch.nonzero((y64 + reach >= r0) & (y64 - reach <= r1))[:, 0]
        m = near.shape[0]
        if m == 0:
            continue
        xs, yb, rs = x[near], y[near], radius[near]
        first = torch.full_like(rows, _NO_HIT)
        for b0 in range(0, m, body_chunk):
            b1 = b0 + body_chunk
            sub = min_hit_index_rows(xs[b0:b1], yb[b0:b1], rs[b0:b1], ys, w,
                                     base_idx=b0)
            torch.minimum(first, sub, out=first)
        # Positions in ``near`` back to body indices (a miss stays a miss).
        body = (near[first.clamp(max=m - 1).long()] + base_idx).to(
            torch.int32)
        rows.copy_(body.masked_fill(first == _NO_HIT, _NO_HIT))
    return best


def _reach(y, radius, h: int):
    """Per body, in float64: a bound on |y - row| beyond which the body hits
    no pixel of that row, for rows in [0, h).  A hit needs
    ``sqrt(dx*dx + dy*dy) <= radius + 0.5`` as computed in the bodies'
    dtype, and the computed distance is at least |dy| but for rounding:
    with eps the dtype's rounding step, the roundings of the row coordinate,
    of dy, of its square, of the sum, of the root and of the threshold move
    the comparison by less than 4 * eps * (h + |y| + radius + 1).  One pixel
    more makes the bound safe by a wide margin (in fp32 the rounding term is
    ~1e-3 px; it matters for bf16, whose step near 768 is 4 px)."""
    eps = torch.finfo(y.dtype).eps
    y64, r64 = y.double(), radius.double()
    return r64 + 1.5 + 4.0 * eps * (h + y64.abs() + r64 + 1.0)
