"""The port's ops against the JAX package: integration, dense forces, the
CUDA kernel's plain version against the Pallas kernel (interpret mode, as
tests/test_pallas_kernel.py runs it), and the coincidence test.

Tolerances and why:
  - integration (both modes, fp64): bit-equal.
  - dense trig forces (fp64): torch's atan2/cos/sin differ from XLA's by at
    most 1 ulp (asserted below), which the row sums carry to within
    1e-14 * max|F|; the golden fixtures still match byte for byte
    (tests/test_torch_engine.py).
  - dense fast forces (fp64): same pair terms, rows summed in another order:
    1e-14 * max|F|.
  - block_forces_reference against pallas_block_forces: the Pallas kernel
    adds the coincident kick through a dx bias (which moves every biased dx
    by about 1 ulp) and sums tile by tile, so atol = 1e-5 * max|F| in fp32
    and 1e-12 * max|F| in fp64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_nbody_tpu.config import SimConfig as JaxConfig
from parallel_nbody_tpu.ops import forces as jforces
from parallel_nbody_tpu.ops import integrate as jintegrate
from parallel_nbody_tpu.ops import pallas_step
from parallel_nbody_tpu_torch.config import SimConfig
from parallel_nbody_tpu_torch.ops import _build, cuda_step
from parallel_nbody_tpu_torch.ops import forces as tforces
from parallel_nbody_tpu_torch.ops import integrate as tintegrate
from torch_cases import BLOCK_CASES, KICK, blocks, glibc_like

torch.set_num_threads(1)

def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _np(t):
    return t.detach().cpu().numpy()


def _assert_bits(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def _assert_close_to_max(got, want, rel):
    got, want = _np(got), np.asarray(want)
    atol = rel * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# integration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["trig", "fast"])
def test_compute_velocities_bit_equal(mode):
    rng = np.random.RandomState(0)
    n = 300
    xv, yv = rng.uniform(-5, 5, n), rng.uniform(-5, 5, n)
    xf, yf = rng.uniform(-1e5, 1e5, n), rng.uniform(-1e5, 1e5, n)
    m = rng.uniform(1, 100, n)
    m[:3] = 0.0  # padding bodies: the 1/m guard
    xv[5] = yv[5] = 0.0  # atan2(0, 0) in the drag
    with np.errstate(divide="ignore"):
        want = jintegrate.compute_velocities(
            JaxConfig(force_mode=mode), xv, yv, xf, yf, m)
    got = tintegrate.compute_velocities(
        SimConfig(force_mode=mode), *map(_t, (xv, yv, xf, yf, m)))
    for g, w in zip(got, want):
        _assert_bits(g, w)


def test_compute_positions_bit_equal():
    rng = np.random.RandomState(1)
    n = 300
    x, y = rng.uniform(-10, 1100, n), rng.uniform(-10, 800, n)
    xv, yv = rng.uniform(-5e5, 5e5, n), rng.uniform(-5e5, 5e5, n)
    m = rng.uniform(1, 100, n)
    m[:4] = 0.0
    for mass in (m, None):
        want = jintegrate.compute_positions(JaxConfig(), x, y, xv, yv, mass)
        got = tintegrate.compute_positions(
            SimConfig(), *map(_t, (x, y, xv, yv)),
            mass=None if mass is None else _t(mass))
        for g, w in zip(got, want):
            _assert_bits(g, w)


# ---------------------------------------------------------------------------
# dense forces
# ---------------------------------------------------------------------------

def test_transcendentals_within_one_ulp():
    x, y, _, _ = glibc_like(200, 2)
    dx = x[None, :] - x[:, None]
    dy = y[None, :] - y[:, None]
    angle = np.asarray(jnp.arctan2(dy, dx))
    pairs = [(jnp.arctan2(dy, dx), torch.atan2(_t(dy), _t(dx))),
             (jnp.cos(angle), torch.cos(_t(angle))),
             (jnp.sin(angle), torch.sin(_t(angle)))]
    for want, got in pairs:
        ulps = np.abs(np.asarray(want).view(np.int64)
                      - _np(got).view(np.int64))
        assert ulps.max() <= 1


@pytest.mark.parametrize("mode", ["trig", "fast"])
def test_compute_forces_dense_matches_jax(mode):
    x, y, m, r = glibc_like(300, 3, coincident=((10, 20), (7, 250)))
    want = jforces.compute_forces_dense(JaxConfig(force_mode=mode), x, y,
                                        m, r)
    got = tforces.compute_forces_dense(SimConfig(force_mode=mode),
                                       *map(_t, (x, y, m, r)))
    for g, w in zip(got, want):
        _assert_close_to_max(g, w, 1e-14)


def test_sequential_row_sum_is_left_to_right():
    s = _t(np.random.RandomState(4).uniform(-1, 1, (7, 50)) * 1e8)
    want = torch.zeros(7, dtype=torch.float64)
    for j in range(50):
        want = want + s[:, j]
    _assert_bits(tforces._sequential_row_sum(s), _np(want))


@pytest.mark.parametrize("mode", ["trig", "fast"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_dense_coincident_kick(mode, dtype):
    cfg = SimConfig(force_mode=mode, dtype=dtype)
    x, y, m, r = (_t(v, dtype) for v in ([100.0, 100.0], [200.0, 200.0],
                                         [5.0, 7.0], [1.5, 1.5]))
    xf, yf = tforces.compute_forces_dense(cfg, x, y, m, r)
    np.testing.assert_allclose(_np(xf), [KICK, -KICK], rtol=1e-6)
    np.testing.assert_allclose(_np(yf), [0.0, 0.0])


# ---------------------------------------------------------------------------
# the kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("biased", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", BLOCK_CASES)
def test_block_forces_reference_matches_pallas(case, dtype, biased):
    rows, cols, g0, c0 = blocks(case)
    rows = [a.astype(dtype) for a in rows]
    cols = [a.astype(dtype) for a in cols]
    want = pallas_step.pallas_block_forces(
        JaxConfig(force_mode="fast", dtype=dtype), *rows, *cols,
        row_g0=g0, col_g0=c0, interpret=True, biased=biased)
    cfg = SimConfig(force_mode="fast", dtype=dtype, kernel="cuda")
    got = cuda_step.block_forces_reference(
        cfg, *map(_t, rows), *map(_t, cols), row_g0=g0, col_g0=c0,
        biased=biased)
    rel = 1e-5 if dtype == "float32" else 1e-12
    scale = max(np.abs(np.asarray(w)).max() for w in want)
    for g, w in zip(got, want):
        assert np.isfinite(_np(g)).all()
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0,
                                   atol=rel * scale)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_block_forces_two_body_kick(dtype):
    cfg = SimConfig(force_mode="fast", dtype=dtype, kernel="cuda")
    b = [_t(v, dtype) for v in ([100.0, 100.0], [200.0, 200.0], [5.0, 7.0],
                                [1.5, 1.5])]
    xf, yf = cuda_step.block_forces(cfg, *b, *b, biased=True)
    np.testing.assert_allclose(_np(xf), [KICK, -KICK], rtol=1e-6)
    np.testing.assert_allclose(_np(yf), [0.0, 0.0])
    # Without the kick a coincident pair exerts nothing (the unbiased
    # kernel is only chosen when no such pair exists).
    xf, yf = cuda_step.block_forces(cfg, *b, *b, biased=False)
    np.testing.assert_array_equal(_np(xf), [0.0, 0.0])


def test_block_forces_device_flag_equals_bool():
    """The 0-d flag tensor (what the engine passes) selects exactly what the
    Python bool selects."""
    rows, cols, _, _ = blocks("square300")
    cfg = SimConfig(force_mode="fast", kernel="cuda")
    args = [*map(_t, rows), *map(_t, cols)]
    for flag in (True, False):
        a = cuda_step.block_forces(cfg, *args, biased=flag)
        b = cuda_step.block_forces(cfg, *args, biased=torch.tensor(flag))
        for u, v in zip(a, b):
            _assert_bits(u, _np(v))


def test_cuda_forces_matches_dense_fast():
    x, y, m, r = glibc_like(256, 8, coincident=((1, 2), (100, 200)))
    cfg = SimConfig(force_mode="fast", kernel="cuda")
    got = cuda_step.cuda_forces(cfg, *map(_t, (x, y, m, r)), biased=True)
    want = tforces.compute_forces_dense(cfg, *map(_t, (x, y, m, r)))
    for g, w in zip(got, want):
        _assert_close_to_max(g, _np(w), 1e-12)


def test_block_forces_cpu_path_launches_nothing():
    before = cuda_step.block_forces.launches
    b = [_t(v) for v in ([1.0, 9.0], [2.0, 5.0], [1.0, 1.0], [1.0, 1.0])]
    cuda_step.block_forces(SimConfig(), *b, *b, biased=False)
    assert cuda_step.block_forces.launches == before


@pytest.mark.parametrize("bad", ["bf16", "mixed_dtype", "strided", "ragged",
                                 "flag_dtype", "meta"])
def test_block_forces_rejects(bad):
    b = [torch.arange(4, dtype=torch.float64) + 1 for _ in range(4)]
    kw = dict(biased=False)
    if bad == "bf16":
        b = [t.to(torch.bfloat16) for t in b]
    elif bad == "mixed_dtype":
        b[2] = b[2].float()
    elif bad == "strided":
        b[0] = torch.arange(8, dtype=torch.float64)[::2]
    elif bad == "ragged":
        b[1] = b[1][:3]
    elif bad == "flag_dtype":
        kw = dict(biased=torch.tensor(1.0))
    elif bad == "meta":
        b = [t.to("meta") for t in b]
    with pytest.raises((TypeError, ValueError)):
        cuda_step.block_forces(SimConfig(), *b, *b, **kw)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    _build.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load()
    finally:
        _build.load.cache_clear()


# ---------------------------------------------------------------------------
# coincidence test
# ---------------------------------------------------------------------------

def _coincidence_cases():
    rng = np.random.RandomState(9)
    x = rng.uniform(0, 1000, 64)
    y = rng.uniform(0, 700, 64)
    m = rng.uniform(1, 10, 64)
    cases = {"distinct": (x, y, m)}
    cases["signed_zero"] = ([-0.0, 0.0, -0.0], [7.0, 7.0, 9.0],
                            [1.0, 1.0, 1.0])
    tx, ty = x.copy(), y.copy()
    tx[[5, 17, 40]] = tx[5]
    ty[[5, 17, 40]] = ty[5]
    cases["triple"] = (tx, ty, m)
    px = np.concatenate([x, np.full(8, 1e9)])
    py = np.concatenate([y, np.full(8, 1e9)])
    pm = np.concatenate([m, np.zeros(8)])
    cases["padding_only"] = (px, py, pm)
    px2, py2 = px.copy(), py.copy()
    px2[3], py2[3] = px2[60], py2[60]
    cases["padding_and_pair"] = (px2, py2, pm)
    tie = m.copy()
    tie[12] = tie[30]
    ex, ey = x.copy(), y.copy()
    ex[12], ey[12] = ex[30], ey[30]
    cases["mass_tie"] = (ex, ey, tie)
    zm = m.copy()
    zm[12] = 0.0
    cases["massless_on_real"] = (ex, ey, zm)
    return cases


@pytest.mark.parametrize("case", sorted(_coincidence_cases()))
def test_any_coincident_matches_jax(case):
    x, y, m = (np.asarray(a, np.float64) for a in _coincidence_cases()[case])
    want = bool(pallas_step.any_coincident(jnp.asarray(x), jnp.asarray(y),
                                           jnp.asarray(m)))
    got = cuda_step.any_coincident(_t(x), _t(y), _t(m))
    assert got.dim() == 0 and got.dtype == torch.bool
    assert bool(got) == want
    expected = case in ("signed_zero", "triple", "padding_and_pair",
                        "mass_tie")
    assert want == expected
