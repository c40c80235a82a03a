"""K2 (``block_forces_streamed``), the ``compensated`` accumulation and bf16
storage of both force kernels: the plain PyTorch versions against the JAX
package's Pallas kernels (interpret mode, as tests/test_pallas_kernel.py,
tests/test_accum.py and tests/test_dtype_envelope.py run them), and the
port's K1/K2 dispatch against the JAX package's.

Tolerances and why:
  - plain versions against the Pallas kernels (fp32/fp64, both accum
    modes): both add the coincident kick through the segmented dx bias,
    at other tile geometries, and sum each tile in another order, so
    atol = 1e-5 * max|F| in fp32 and 1e-12 * max|F| in fp64, as
    tests/test_torch_ops.py holds K1; at Pallas's own geometry 2e-6 and
    1e-14.
  - the kick of one coincident pair in each bias segment: rtol 1e-6.
  - magnitude-spread case: the bounds of tests/test_accum.py (plain error
    > 5e-7, compensated < 3e-7, relative to the exact sum).
  - bf16 storage: the plain versions on bf16 inputs are bit-equal to their
    fp32 result on the upcast inputs rounded once (the kernels' contract,
    tests/test_dtype_envelope.py).  Against the Pallas bf16 kernels the
    fp32 sums differ at rounding level, which can move the one final
    rounding across a bf16 rounding boundary: 1 bf16 ulp per element.
  - row chunks with ``row_g0`` against the square call: bit-equal (each
    row's arithmetic does not depend on the other rows).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parallel_nbody_tpu.config import SimConfig as JaxConfig
from parallel_nbody_tpu.ops import pallas_step
from parallel_nbody_tpu_torch.config import SimConfig
from parallel_nbody_tpu_torch.ops import cuda_step
from torch_cases import (BLOCK_CASES, KICK, KICK_PLACEMENTS, SEGMENT_CASES,
                         bf16_ulps, blocks, glibc_like, kick_case,
                         segment_blocks)

torch.set_num_threads(1)

LIMIT = cuda_step.STREAMED_ABOVE


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _np(t):
    return t.detach().cpu().float().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().cpu().numpy()


def _cfg(dtype):
    return SimConfig(force_mode="fast", dtype=dtype, kernel="cuda")


def _assert_close_to_max(got, want, rel):
    scale = max(np.abs(np.asarray(w, np.float64)).max() for w in want)
    for g, w in zip(got, want):
        g = _np(g)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w, g.dtype), rtol=0,
                                   atol=rel * scale)


def test_constants_match_jax():
    assert cuda_step.STREAMED_ABOVE == pallas_step._VMEM_RESIDENT_LIMIT
    assert cuda_step.STREAM_BAND == 65536


@pytest.mark.parametrize("k, band, want", [
    (300, 128, 128), (300, 256, 256), (300, 65536, 384), (300, 200, 128),
    (0, 65536, 128), (262144, 65536, 65536), (4097, 1024, 1024)])
def test_band_width_matches_pallas_rounding(k, band, want):
    assert cuda_step.band_width(k, band) == want


# ---------------------------------------------------------------------------
# K2's plain version against the Pallas streamed kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accum", ["plain", "compensated"])
@pytest.mark.parametrize("band", [128, 256])
@pytest.mark.parametrize("biased", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", BLOCK_CASES)
def test_streamed_reference_matches_pallas(case, dtype, biased, band, accum):
    rows, cols, g0, c0 = blocks(case)
    rows = [a.astype(dtype) for a in rows]
    cols = [a.astype(dtype) for a in cols]
    want = pallas_step.pallas_block_forces_streamed(
        JaxConfig(force_mode="fast", dtype=dtype), *rows, *cols,
        row_g0=g0, col_g0=c0, tile_i=128, tile_j=128, band=band,
        interpret=True, biased=biased, accum=accum)
    got = cuda_step.block_forces_streamed(
        _cfg(dtype), *map(_t, rows), *map(_t, cols), row_g0=g0, col_g0=c0,
        band=band, biased=biased, accum=accum)
    _assert_close_to_max(got, want, 1e-5 if dtype == "float32" else 1e-12)


@pytest.mark.parametrize("biased", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", BLOCK_CASES)
def test_block_forces_compensated_matches_pallas(case, dtype, biased):
    rows, cols, g0, c0 = blocks(case)
    rows = [a.astype(dtype) for a in rows]
    cols = [a.astype(dtype) for a in cols]
    want = pallas_step.pallas_block_forces(
        JaxConfig(force_mode="fast", dtype=dtype), *rows, *cols,
        row_g0=g0, col_g0=c0, tile_i=128, tile_j=128, interpret=True,
        biased=biased, accum="compensated")
    got = cuda_step.block_forces(
        _cfg(dtype), *map(_t, rows), *map(_t, cols), row_g0=g0, col_g0=c0,
        biased=biased, accum="compensated")
    _assert_close_to_max(got, want, 1e-5 if dtype == "float32" else 1e-12)


@pytest.mark.parametrize("accum", ["plain", "compensated"])
def test_streamed_two_body_kick(accum):
    cfg = _cfg("float64")
    b = [_t(v) for v in ([100.0, 100.0], [200.0, 200.0], [5.0, 7.0],
                         [1.5, 1.5])]
    xf, yf = cuda_step.block_forces_streamed(cfg, *b, *b, biased=True,
                                             accum=accum)
    np.testing.assert_allclose(_np(xf), [KICK, -KICK], rtol=1e-6)
    np.testing.assert_allclose(_np(yf), [0.0, 0.0])


@pytest.mark.parametrize("band", [1024, 2048])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_streamed_reference_at_pallas_geometry(case, dtype, band):
    """K2's plain version at the Pallas geometry (1024-row blocks, 1024-wide
    tiles counted from each band's start) against the Pallas streamed kernel
    at tile_i = tile_j = 1024: the same bias on every pair, so only the
    summation order differs (tolerances of
    test_torch_ops.test_block_forces_reference_at_pallas_geometry)."""
    rows, cols, g0, c0 = segment_blocks(case)
    rows = [a.astype(dtype) for a in rows]
    cols = [a.astype(dtype) for a in cols]
    want = pallas_step.pallas_block_forces_streamed(
        JaxConfig(force_mode="fast", dtype=dtype), *rows, *cols,
        row_g0=g0, col_g0=c0, tile_i=1024, tile_j=1024, band=band,
        interpret=True, biased=True)
    got = cuda_step.block_forces_streamed_reference(
        _cfg(dtype), *map(_t, rows), *map(_t, cols), row_g0=g0, col_g0=c0,
        band=band, biased=True, tile=1024, row_block=1024)
    _assert_close_to_max(got, want, 2e-6 if dtype == "float32" else 1e-14)


@pytest.mark.parametrize("band", [128, 256])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("place", sorted(KICK_PLACEMENTS))
def test_streamed_reference_kick_in_each_segment(place, dtype, band):
    rows, cols, g0, c0, (ia, ib) = kick_case(place)
    xf, yf = cuda_step.block_forces_streamed_reference(
        _cfg(dtype), *(_t(a, dtype) for a in rows),
        *(_t(a, dtype) for a in cols), row_g0=g0, col_g0=c0, band=band,
        biased=True)
    xf, yf = _np(xf), _np(yf)
    np.testing.assert_allclose(xf[[ia, ib]], [KICK, -KICK], rtol=1e-6)
    assert np.count_nonzero(xf) == 2 and not yf.any()


def test_streamed_kick_across_bands():
    """A coincident pair whose bodies sit in different bands (global ids 10
    and 300, band 128): the kick's sign comes from the global ids, not from
    band-local ones."""
    x, y, m, r = glibc_like(384, 11, coincident=((10, 300),))
    cfg = _cfg("float64")
    args = [*map(_t, (x, y, m, r))] * 2
    want = cuda_step.block_forces_reference(cfg, *args, biased=True)
    got = cuda_step.block_forces_streamed(cfg, *args, band=128, biased=True)
    _assert_close_to_max(got, [_np(w) for w in want], 1e-12)
    off = cuda_step.block_forces_streamed(cfg, *args, band=128,
                                          biased=False)
    # The kick is what separates the pair: without it their x forces lack
    # G * m_i * m_j / forced of opposite signs.
    assert _np(got[0])[10] - _np(off[0])[10] > 0
    assert _np(got[0])[300] - _np(off[0])[300] < 0


def test_streamed_row_chunks_with_row_g0_match_square():
    """The row-chunk access pattern of tests/test_pallas_kernel.py:231-260:
    row chunks over a shared column set with their ``row_g0`` and the kick
    on, a coincident pair split across chunks.  A wrong ``row_g0`` hands
    every body a spurious self-kick."""
    n, row_chunk = 256, 64
    rng = np.random.RandomState(1)
    x = rng.uniform(0, 1024, n).astype(np.float32)
    y = rng.uniform(0, 768, n).astype(np.float32)
    radius = (1.0 + rng.uniform(0, 5, n)).astype(np.float32)
    mass = radius ** 3
    x[130], y[130] = x[3], y[3]
    cfg = _cfg("float32")
    cols = list(map(_t, (x, y, mass, radius)))
    want = cuda_step.block_forces_streamed(cfg, *cols, *cols, biased=True)
    parts = [cuda_step.block_forces_streamed(
        cfg, *(c[r0:r0 + row_chunk].contiguous() for c in cols), *cols,
        row_g0=r0, col_g0=0, biased=True)
        for r0 in range(0, n, row_chunk)]
    for i in range(2):
        np.testing.assert_array_equal(
            np.concatenate([_np(p[i]) for p in parts]), _np(want[i]))
    jax_want = pallas_step.pallas_block_forces_streamed(
        JaxConfig(force_mode="fast", dtype="float32"), x, y, mass, radius,
        x, y, mass, radius, interpret=True, biased=True)
    _assert_close_to_max(want, jax_want, 1e-5)


@pytest.mark.parametrize("accum", ["plain", "compensated"])
@pytest.mark.parametrize("rows, cols", [((256, 512), (0, 512)),
                                        ((128, 384), (384, 512))])
def test_rank_k2_row_launches_match_one_launch(rows, cols, accum,
                                               monkeypatch):
    """A rank's K2 block through ``block_forces_auto``, with the threshold
    and K2's workspace bound lowered so that it runs in row launches of one
    tile: an all-gather rank's rows against every body, and a ring rank's
    rows against a visiting block.  The launches start at ``row_g0`` plus
    whole tiles and give one launch of the plain version bit for bit, with
    a row of each launch on a column's position."""
    pairs = ((rows[0] + 3, cols[0] + 5), (rows[0] + 130, cols[0] + 9))
    b = [a.astype(np.float32) for a in glibc_like(512, 7, pairs)]
    state = list(map(_t, b))
    rb = [t[slice(*rows)] for t in state]
    cb = [t[slice(*cols)] for t in state]
    cfg = _cfg("float32")
    want = cuda_step.block_forces_streamed_reference(
        cfg, *rb, *cb, row_g0=rows[0], col_g0=cols[0], biased=True,
        accum=accum)
    launches = []
    plain = cuda_step.block_forces_streamed_reference

    def spy(cfg, xi, *a, **kw):
        launches.append((kw["row_g0"], xi.shape[0]))
        return plain(cfg, xi, *a, **kw)

    monkeypatch.setattr(cuda_step, "block_forces_streamed_reference", spy)
    monkeypatch.setattr(cuda_step, "STREAMED_ABOVE", 64)
    monkeypatch.setattr(cuda_step, "K2_WORKSPACE_BYTES", cuda_step.TILE * 8)
    got = cuda_step.block_forces_auto(cfg, *rb, *cb, row_g0=rows[0],
                                      col_g0=cols[0], biased=True,
                                      accum=accum)
    m = rows[1] - rows[0]
    assert launches == [(rows[0] + r0, cuda_step.TILE)
                        for r0 in range(0, m, cuda_step.TILE)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    off = cuda_step.block_forces_streamed_reference(
        cfg, *rb, *cb, row_g0=rows[0], col_g0=cols[0], biased=False,
        accum=accum)
    assert not torch.equal(got[0], off[0])


# ---------------------------------------------------------------------------
# compensated accumulation: the magnitude-spread case of tests/test_accum.py
# ---------------------------------------------------------------------------

def _magnitude_spread_case():
    """tests/test_accum.py:24-41: one row body against 4096 column bodies
    at unit distance along +x; column 0 carries 2**24, the rest 0.9/128
    each, so every later tile's partial (0.9) is below half an ulp of the
    running sum."""
    n_cols = 4096
    mj = np.full(n_cols, 0.9 / 128, np.float32)
    mj[0] = 2.0 ** 24
    rows = [np.zeros(1, np.float32), np.zeros(1, np.float32),
            np.ones(1, np.float32), np.full(1, 0.1, np.float32)]
    cols = [np.ones(n_cols, np.float32), np.zeros(n_cols, np.float32), mj,
            np.full(n_cols, 0.1, np.float32)]
    exact = 1.1 * (2.0 ** 24 + (n_cols - 1) * (0.9 / 128))
    return [*map(_t, rows), *map(_t, cols)], exact


@pytest.mark.parametrize("kernel", ["block_forces", "block_forces_streamed"])
def test_compensated_recovers_small_contributions(kernel):
    args, exact = _magnitude_spread_case()
    kw = dict(band=128) if kernel == "block_forces_streamed" else {}
    fn = getattr(cuda_step, kernel)

    def err(accum):
        fx, _ = fn(_cfg("float32"), *args, row_g0=0, col_g0=8192,
                   biased=False, accum=accum, **kw)
        return abs(float(fx[0]) - exact) / exact

    e_plain, e_comp = err("plain"), err("compensated")
    assert e_plain > 5e-7, e_plain
    assert e_comp < 3e-7, e_comp
    assert e_comp < e_plain / 3


def test_compensated_streamed_matches_resident():
    """tests/test_accum.py:104-120: K2 with several bands against K1, both
    compensated, on a glibc-like block: the band decomposition changes
    rounding only."""
    b = list(map(_t, (a.astype(np.float32) for a in glibc_like(1024, 12))))
    cfg = _cfg("float32")
    fr = cuda_step.block_forces(cfg, *b, *b, biased=True,
                                accum="compensated")
    fs = cuda_step.block_forces_streamed(cfg, *b, *b, band=256, biased=True,
                                         accum="compensated")
    _assert_close_to_max(fs, [_np(f) for f in fr], 1e-6)


# ---------------------------------------------------------------------------
# bf16 storage
# ---------------------------------------------------------------------------

def _bf16_inputs(n, seed):
    """glibc-like bodies rounded to bf16 once (float32 -> bf16 in both
    packages, so the bits agree): (jax arrays, torch tensors)."""
    f32 = [a.astype(np.float32) for a in glibc_like(n, seed,
                                                      ((3, 90), (7, 8)))]
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in f32]
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in f32]
    for j, t in zip(jb, tb):
        np.testing.assert_array_equal(np.asarray(j, np.float32), _np(t))
    return jb, tb


@pytest.mark.parametrize("accum", ["plain", "compensated"])
@pytest.mark.parametrize("biased", [True, False])
@pytest.mark.parametrize("kernel", ["block_forces", "block_forces_streamed"])
def test_bf16_is_fp32_rounded_once(kernel, biased, accum):
    _, tb = _bf16_inputs(300, 13)
    kw = dict(band=128) if kernel == "block_forces_streamed" else {}
    fn = getattr(cuda_step, kernel)
    got = fn(_cfg("bfloat16"), *tb, *tb, biased=biased, accum=accum, **kw)
    t32 = [t.float() for t in tb]
    want = fn(_cfg("float32"), *t32, *t32, biased=biased, accum=accum, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w.to(torch.bfloat16))


@pytest.mark.parametrize("accum", ["plain", "compensated"])
@pytest.mark.parametrize("biased", [True, False])
@pytest.mark.parametrize("kernel", ["block_forces", "block_forces_streamed"])
def test_bf16_matches_pallas_within_one_ulp(kernel, biased, accum):
    jb, tb = _bf16_inputs(300, 14)
    jcfg = JaxConfig(force_mode="fast", dtype="bfloat16")
    if kernel == "block_forces":
        want = pallas_step.pallas_block_forces(
            jcfg, *jb, *jb, tile_i=128, tile_j=128, interpret=True,
            biased=biased, accum=accum)
        got = cuda_step.block_forces(_cfg("bfloat16"), *tb, *tb,
                                     biased=biased, accum=accum)
    else:
        want = pallas_step.pallas_block_forces_streamed(
            jcfg, *jb, *jb, tile_i=128, tile_j=128, band=128,
            interpret=True, biased=biased, accum=accum)
        got = cuda_step.block_forces_streamed(_cfg("bfloat16"), *tb, *tb,
                                              band=128, biased=biased,
                                              accum=accum)
    for g, w in zip(got, want):
        assert w.dtype == jnp.bfloat16 and g.dtype == torch.bfloat16
        assert bf16_ulps(_np(g), w).max() <= 1


# ---------------------------------------------------------------------------
# dispatch: K2 exactly where the JAX package picks K2
# ---------------------------------------------------------------------------

def _record(calls, name, out_like):
    def stub(cfg, xi, *a, **kw):
        calls.append((name, kw.get("accum")))
        return out_like(xi), out_like(xi)
    return stub


@pytest.mark.parametrize("m, k", [(LIMIT, LIMIT), (LIMIT + 1, LIMIT + 1),
                                  (LIMIT + 1, 256), (256, LIMIT + 1),
                                  (LIMIT, 256)])
def test_dispatch_matches_jax(m, k, monkeypatch):
    """Stubs record which kernel each package picks (no force is computed):
    ``pallas_forces``/``pallas_block_forces_auto`` against ``cuda_forces``/
    ``block_forces_auto`` at the real threshold."""
    jcalls, tcalls = [], []
    monkeypatch.setattr(pallas_step, "pallas_block_forces",
                        _record(jcalls, "K1", jnp.zeros_like))
    monkeypatch.setattr(pallas_step, "pallas_block_forces_streamed",
                        _record(jcalls, "K2", jnp.zeros_like))
    monkeypatch.setattr(cuda_step, "block_forces_reference",
                        _record(tcalls, "K1", torch.zeros_like))
    monkeypatch.setattr(cuda_step, "block_forces_streamed_reference",
                        _record(tcalls, "K2", torch.zeros_like))
    jcfg = JaxConfig(force_mode="fast", dtype="float32", kernel="pallas")
    rows_np = [np.zeros(m, np.float32)] * 4
    cols_np = [np.zeros(k, np.float32)] * 4
    rows = [torch.zeros(m) for _ in range(4)]
    cols = [torch.zeros(k) for _ in range(4)]
    pallas_step.pallas_block_forces_auto(jcfg, *rows_np, *cols_np,
                                         accum="compensated")
    cuda_step.block_forces_auto(_cfg("float32"), *rows, *cols, biased=False,
                                accum="compensated")
    if m == k:
        pallas_step.pallas_forces(jcfg, *rows_np, accum="plain")
        cuda_step.cuda_forces(_cfg("float32"), *rows, biased=False)
    assert tcalls == jcalls
    assert jcalls[0][0] == ("K2" if max(m, k) > LIMIT else "K1")


def test_dispatch_boundary_results(monkeypatch):
    """With the port's threshold lowered to 256 (tests/test_pallas_kernel.py
    lowers the JAX one the same way), N=256 runs K1's plain version, N=320
    K2's, and both agree with the Pallas kernels."""
    calls = []
    k1, k2 = (cuda_step.block_forces_reference,
              cuda_step.block_forces_streamed_reference)

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(cuda_step, "STREAMED_ABOVE", 256)
    monkeypatch.setattr(cuda_step, "block_forces_reference", spy("K1", k1))
    monkeypatch.setattr(cuda_step, "block_forces_streamed_reference",
                        spy("K2", k2))
    jcfg = JaxConfig(force_mode="fast", dtype="float32")
    for n, kernel, jax_fn in ((256, "K1", pallas_step.pallas_block_forces),
                              (320, "K2",
                               pallas_step.pallas_block_forces_streamed)):
        b = [a.astype(np.float32) for a in glibc_like(n, 15)]
        got = cuda_step.cuda_forces(_cfg("float32"), *map(_t, b),
                                    biased=True)
        assert calls[-1] == kernel
        want = jax_fn(jcfg, *b, *b, interpret=True, biased=True)
        _assert_close_to_max(got, want, 1e-5)
    assert calls == ["K1", "K2"]


def test_streamed_rejects():
    b = [torch.arange(4, dtype=torch.float64) + 1 for _ in range(4)]
    with pytest.raises(ValueError, match="accum"):
        cuda_step.block_forces_streamed(SimConfig(), *b, *b, biased=False,
                                        accum="kahan")
    with pytest.raises(TypeError):
        cuda_step.block_forces_streamed(
            SimConfig(), *(t.half() for t in b), *(t.half() for t in b),
            biased=False)


def test_streamed_cpu_path_launches_nothing():
    before = cuda_step.block_forces_streamed.launches
    b = [_t(v) for v in ([1.0, 9.0], [2.0, 5.0], [1.0, 1.0], [1.0, 1.0])]
    cuda_step.block_forces_streamed(SimConfig(), *b, *b, biased=False)
    assert cuda_step.block_forces_streamed.launches == before
