"""The port's ops against the JAX package: integration, dense forces, the
CUDA kernel's plain version against the Pallas kernel (interpret mode, as
tests/test_pallas_kernel.py runs it), and the coincidence test.

Tolerances and why:
  - integration (both modes, fp64): bit-equal.
  - bf16 integration and dense forces: in bf16 ulps, with the measured
    mismatches beside the bf16 tests below.
  - dense trig forces (fp64): torch's atan2/cos/sin differ from XLA's by at
    most 1 ulp (asserted below), which the row sums carry to within
    1e-14 * max|F|; the golden fixtures still match byte for byte
    (tests/test_torch_engine.py).
  - dense fast forces (fp64): same pair terms, rows summed in another order:
    1e-14 * max|F|.
  - block_forces_reference against pallas_block_forces: both add the
    coincident kick through the segmented dx bias, but at the kernels'
    geometry (128-row blocks, 128-wide tiles) a pair may get the constant
    bias where Pallas's 1024-wide tiles give it the per-pair one (in fp64
    every dx feels the difference), and the tiles are summed in another
    order, so atol = 1e-5 * max|F| in fp32 and 1e-12 * max|F| in fp64.  At
    Pallas's own geometry only the order differs: 2e-6 and 1e-14.
  - the kick of one coincident pair in each bias segment: rtol 1e-6 (the
    kick is m_j / forced to a few ulps of the rsqrt).
  - --pallas in fp64 through the CLI: none; stdout byte-equal to the
    reference binary's committed outputs.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_nbody_tpu.config import SimConfig as JaxConfig
from parallel_nbody_tpu.ops import forces as jforces
from parallel_nbody_tpu.ops import integrate as jintegrate
from parallel_nbody_tpu.ops import pallas_step
from parallel_nbody_tpu_torch import cli
from parallel_nbody_tpu_torch.config import SimConfig
from parallel_nbody_tpu_torch.ops import _build, cuda_step
from parallel_nbody_tpu_torch.ops import forces as tforces
from parallel_nbody_tpu_torch.ops import integrate as tintegrate
from torch_cases import (BLOCK_CASES, COINCIDENCE_CASES, COLLIDING_KEYS, KICK,
                         KICK_PLACEMENTS, SEGMENT_CASES, bf16_ulps, blocks,
                         coincidence_cases, coincidence_hash, glibc_like,
                         kick_case, segment_blocks)

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
# bf16 on the dense path and in integration
# ---------------------------------------------------------------------------
#
# XLA keeps excess precision inside some fused bf16 expressions and rounds
# at others, while torch rounds every bf16 op to bf16.  So the two packages
# do not agree bit for bit in bf16, and these tests state their tolerance in
# bf16 ulps.  Measured on the CPU (N=256 glibc init, forces
# numpy.random.default_rng(0) * 1e6): compute_velocities differs in 6 of 256
# xv and 5 of 256 yv, by at most 2 ulps; compute_positions in 1 of 256 x by
# 1 ulp; the dense fast forces in 115 of 256 xf and 103 of 256 yf, by at
# most 1 ulp of max|F| (16384 on about 4.7e6).

def _bf16(a):
    """float64 -> float32 -> bf16 in both packages (the same bits)."""
    f32 = np.asarray(a, np.float32)
    return jnp.asarray(f32).astype(jnp.bfloat16), \
        torch.from_numpy(f32).to(torch.bfloat16)


def _bf16_state(n=256):
    from parallel_nbody_tpu.state import init_state as jax_init_state
    jst = jax_init_state(n, JaxConfig(dtype="bfloat16"))
    return {f: _bf16(np.asarray(getattr(jst, f), np.float32))
            for f in ("x", "y", "xv", "yv", "mass", "radius")}


@pytest.mark.parametrize("mode", ["trig", "fast"])
def test_compute_velocities_bf16_within_2_ulps(mode):
    st = _bf16_state()
    rng = np.random.default_rng(0)
    xf, yf = _bf16(rng.standard_normal(256) * 1e6), \
        _bf16(rng.standard_normal(256) * 1e6)
    args = [st["xv"], st["yv"], xf, yf, st["mass"]]
    want = jax.jit(lambda *a: jintegrate.compute_velocities(
        JaxConfig(force_mode=mode, dtype="bfloat16"), *a))(
            *(a[0] for a in args))
    got = tintegrate.compute_velocities(
        SimConfig(force_mode=mode, dtype="bfloat16"), *(a[1] for a in args))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        ulps = bf16_ulps(g.float().numpy(), w)
        assert ulps.max() <= 2 and (ulps > 0).sum() <= 8


def test_compute_positions_bf16_within_1_ulp():
    st = _bf16_state()
    rng = np.random.default_rng(1)
    xv, yv = _bf16(rng.standard_normal(256) * 2e5), \
        _bf16(rng.standard_normal(256) * 2e5)
    args = [st["x"], st["y"], xv, yv]
    cfgs = (JaxConfig(dtype="bfloat16"), SimConfig(dtype="bfloat16"))
    want = jax.jit(lambda *a: jintegrate.compute_positions(cfgs[0], *a))(
        *(a[0] for a in args), st["mass"][0])
    got = tintegrate.compute_positions(cfgs[1], *(a[1] for a in args),
                                       mass=st["mass"][1])
    for g, w in zip(got, want):
        assert bf16_ulps(g.float().numpy(), w).max() <= 1


def test_bf16_high_wall_clamp():
    """ROADMAP Q3: the high wall clamps to dim - 1 rounded to bf16, 1024 for
    xdim=1024 and 768 for ydim=768 — on the wall itself, outside [0, dim).
    The port keeps this defect of the reference on purpose, to stay equal to
    the JAX package."""
    x, y = _bf16([1020.0, 10.0, 1000.0]), _bf16([760.0, 766.0, 10.0])
    xv, yv = _bf16([2.0 ** 20, 0.0, -1.0]), _bf16([0.0, 2.0 ** 20, 0.0])
    want = jintegrate.compute_positions(JaxConfig(dtype="bfloat16"), x[0],
                                        y[0], xv[0], yv[0])
    got = tintegrate.compute_positions(SimConfig(dtype="bfloat16"), x[1],
                                       y[1], xv[1], yv[1])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    xn, yn, xvn, yvn = (g.float().numpy() for g in got)
    assert xn[0] == 1024.0 and yn[1] == 768.0
    assert xvn[0] == yvn[1] == -2.0 ** 20 and xvn[2] == -1.0


def test_compute_forces_dense_bf16_within_1_ulp_of_max():
    st = _bf16_state()
    args = [st[f] for f in ("x", "y", "mass", "radius")]
    cfgs = (JaxConfig(force_mode="fast", dtype="bfloat16"),
            SimConfig(force_mode="fast", dtype="bfloat16"))
    want = jax.jit(lambda *a: jforces.compute_forces_dense(cfgs[0], *a))(
        *(a[0] for a in args))
    got = tforces.compute_forces_dense(cfgs[1], *(a[1] for a in args))
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        top = np.abs(w).max()
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7)  # bf16 step at max|F|
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=ulp)


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


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n, steps, oracle", [
    (2, 1000, "tests/fixtures/seq_2_1000.out"),
    (64, 500, "tests/fixtures/seq_64_500.out"),
    (116, 302, "tests_out/fuzz/seq_116_302.out"),
])
def test_pallas_fp64_prints_reference_bytes(n, steps, oracle, tmp_path,
                                            capsys, monkeypatch):
    """--pallas in fp64 on the CPU: K1's plain version (the TPU kernel's
    fast formula, its tile order and the coincident dispatch) once a step,
    and the reference binary's bytes (a fixture, and one of the fuzz
    oracles that the card's replay also runs)."""
    from parallel_nbody_tpu_torch.utils import ppm
    arena = str(tmp_path / "arena.ppm")
    ppm.create(arena, 1024, 768)
    calls = []
    plain = cuda_step.block_forces_reference
    monkeypatch.setattr(cuda_step, "block_forces_reference",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    monkeypatch.setenv("NBODY_PLATFORM", "cpu")
    capsys.readouterr()
    rc = cli.main(["nbody", str(n), "0", arena, str(steps), "--pallas",
                   "--dtype=float64"])
    out = capsys.readouterr()
    assert rc == 0, out.err
    with open(os.path.join(REPO, oracle)) as f:
        assert out.out == f.read()
    assert len(calls) == steps


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


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_block_forces_reference_at_pallas_geometry(case, dtype):
    """With 1024-row blocks and 1024-wide tiles the plain version gives
    every pair the Pallas kernel's own bias, coincident pairs in tiles
    below, above and overlapping (two overlapping tiles per row block when
    the rows start at 600), so only the summation order differs: atol
    2e-6 * max|F| in fp32 and 1e-14 in fp64 (measured on the CPU: 2.9e-7
    and 4.1e-16; at the kernels' 128/128 geometry fp64 differs by 1.3e-13,
    the other segments' bias, which the 1e-12 above absorbs)."""
    rows, cols, g0, c0 = segment_blocks(case)
    rows = [a.astype(dtype) for a in rows]
    cols = [a.astype(dtype) for a in cols]
    want = pallas_step.pallas_block_forces(
        JaxConfig(force_mode="fast", dtype=dtype), *rows, *cols,
        row_g0=g0, col_g0=c0, tile_i=1024, tile_j=1024, interpret=True,
        biased=True)
    cfg = SimConfig(force_mode="fast", dtype=dtype, kernel="cuda")
    got = cuda_step.block_forces_reference(
        cfg, *map(_t, rows), *map(_t, cols), row_g0=g0, col_g0=c0,
        biased=True, tile=1024, row_block=1024)
    rel = 2e-6 if dtype == "float32" else 1e-14
    scale = max(np.abs(np.asarray(w)).max() for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0,
                                   atol=rel * scale)


def _segment(bias, cbias):
    return {-cbias: "below", cbias: "above"}.get(bias, "pair")


def test_kick_placements_cover_every_segment():
    """Each placement puts the pair's two terms where KICK_PLACEMENTS says:
    per-pair bias (|b| < C, and 0 for no pair), -C below, +C above."""
    cbias, pbias = cuda_step._BIAS[torch.float64]
    for place, (pair, _, _, want) in KICK_PLACEMENTS.items():
        rows, cols, g0, c0, (ia, ib) = kick_case(place)
        bias = _np(cuda_step.dx_bias(range(len(rows[0])), len(cols[0]),
                                     row_g0=g0, col_g0=c0, row_block=128,
                                     tile=128, dtype=torch.float64))
        terms = (bias[ia, pair[1] - c0], bias[ib, pair[0] - c0])
        assert tuple(_segment(b, cbias) for b in terms) == want, place
        for b, sign in zip(terms, (1, -1)):
            assert np.sign(b) == sign
            if _segment(b, cbias) == "pair":
                assert b == sign * (pair[1] - pair[0]) * pbias
    # With misaligned offsets a row block overlaps two column tiles.
    rows, cols, g0, c0, _ = kick_case("misaligned")
    bias = _np(cuda_step.dx_bias(range(128, 256), len(cols[0]), row_g0=g0,
                                 col_g0=c0, row_block=128, tile=128,
                                 dtype=torch.float64))
    per_pair = np.abs(bias) < cbias
    assert per_pair.all(0).sum() == 256 and per_pair.sum() == 128 * 256


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("place", sorted(KICK_PLACEMENTS))
def test_block_forces_reference_kick_in_each_segment(place, dtype):
    rows, cols, g0, c0, (ia, ib) = kick_case(place)
    cfg = SimConfig(force_mode="fast", dtype=dtype, kernel="cuda")
    xf, yf = cuda_step.block_forces_reference(
        cfg, *(_t(a, dtype) for a in rows), *(_t(a, dtype) for a in cols),
        row_g0=g0, col_g0=c0, biased=True)
    xf, yf = _np(xf), _np(yf)
    np.testing.assert_allclose(xf[[ia, ib]], [KICK, -KICK], rtol=1e-6)
    assert np.count_nonzero(xf) == 2 and not yf.any()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bias_on_non_coincident_pairs_within_bound(dtype):
    """No two bodies coincide: the bias only perturbs.  It moves each dx by
    at most C (2^-26 in fp32, 2^-40 in fp64; the per-pair bias is at most
    255 * P, far below).  With radii >= 1 (forced >= 4) and positions on
    integer pixels (|d| >= 1), a pair term m_j * (dx, dy) / (forced * |d|)
    moves by at most m_j / 4 per unit of dx, so each force moves by at most
    |G m_i| * C / 4 * sum_j m_j.  (Measured: 7.4e-5 of that bound in fp64,
    where every dx moves; 4.0e-5 in fp32, where only pairs with dx == 0
    move, since C is below half an ulp of any |dx| >= 1.)"""
    x, y, m, r = glibc_like(400, 40, ())
    assert not bool(cuda_step.any_coincident(_t(x), _t(y), _t(m)))
    b = [_t(a, dtype) for a in (x, y, m, r)]
    cfg = SimConfig(force_mode="fast", dtype=dtype, kernel="cuda")
    cbias = cuda_step._BIAS[b[0].dtype][0]
    bias = _np(cuda_step.dx_bias(range(400), 400, row_g0=0, col_g0=0,
                                 row_block=128, tile=128, dtype=b[0].dtype))
    assert np.abs(bias).max() == cbias
    on = cuda_step.block_forces_reference(cfg, *b, *b, biased=True)
    off = cuda_step.block_forces_reference(cfg, *b, *b, biased=False)
    bound = np.abs(cfg.gravity * m) * cbias / 4 * m.sum()
    for u, v in zip(on, off):
        diff = np.abs(_np(u).astype(np.float64) - _np(v))
        assert (diff <= bound).all()
    assert any((_np(u) != _np(v)).any() for u, v in zip(on, off))


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
                                 "flag_dtype", "meta", "fp16", "accum"])
def test_block_forces_rejects(bad):
    b = [torch.arange(4, dtype=torch.float64) + 1 for _ in range(4)]
    kw = dict(biased=False)
    if bad == "bf16":
        # bf16 is a storage format the kernels take, but only for every
        # tensor of the call: bf16 positions with fp32 masses are refused.
        b = [t.to(torch.bfloat16) for t in b]
        b[2] = b[2].float()
    elif bad == "fp16":
        b = [t.half() for t in b]
    elif bad == "accum":
        kw = dict(biased=False, accum="kahan")
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


@pytest.mark.parametrize("name", ["kernels", "probes"])
def test_build_compiles_each_source_to_its_own_object(name, monkeypatch,
                                                      tmp_path):
    """``load`` starts one nvcc a source, each with the same NVCC_FLAGS and
    ``-c`` (no relocatable device code, no device LTO), and links the
    objects: a kernel's SASS is what its own source compiles to, whatever
    else its library holds."""
    runs = []

    def run_all(cmds):
        runs.append(cmds)
        return ([(cmds[0], 1, "stopped")] if len(runs) == 2 else []), ""

    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_run_all", run_all)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    _build.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="stopped"):
            _build.load(name)
    finally:
        _build.load.cache_clear()
    compiles, (link,) = runs
    files = _build.LIBRARIES[name][0]
    assert len(compiles) == len(files)
    objs = [cmd[-2] for cmd in compiles]
    for cmd, obj, f in zip(compiles, objs, files):
        assert cmd == ["nvcc", *_build.NVCC_FLAGS, "-c", "-o", obj,
                       os.path.join(_build._CSRC, f)]
    assert len(set(objs)) == len(objs)
    assert link == ["nvcc", "-shared", "-o", link[3], *objs]
    assert not any("lto" in f or "rdc" in f for f in _build.NVCC_FLAGS)


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
    # The rule csrc/coincident.cu keeps: NaN masses fire beside a positive
    # one only, NaN positions equal nothing.  JAX's lax.sort orders these
    # as torch.sort does (NaN last), so every case is held to JAX.
    nan = float("nan")
    for name, pair in (("nan_mass_and_5", [nan, 5.0]),
                       ("nan_masses", [nan, nan]),
                       ("zero_and_nan_mass", [0.0, nan])):
        nm = m.copy()
        nm[[12, 30]] = pair
        cases[name] = (ex, ey, nm)
    nx, ny = x.copy(), y.copy()
    nx[[3, 4]] = nan
    ny[[5, 6]] = nan
    nx[[5, 6]] = nx[7]
    cases["nan_positions"] = (nx, ny, m)
    nx2 = nx.copy()
    nx2[9] = nx2[8] = nx[20]
    ny2 = ny.copy()
    ny2[9] = ny2[8] = ny[20]
    cases["nan_between_a_pair"] = (nx2, ny2, m)
    cases["one_point"] = (np.full(64, 3.0), np.full(64, 4.0), m)
    cases["one_body"] = ([1.0], [2.0], [3.0])
    cases["two_bodies"] = ([1.0, 1.0], [2.0, 2.0], [3.0, 0.5])
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
                        "mass_tie", "nan_mass_and_5", "nan_between_a_pair",
                        "one_point", "two_bodies")
    assert want == expected


def test_any_coincident_on_cpu_runs_the_plain_version(monkeypatch):
    """On CPU tensors the wrapper is the sort (three stable sorts) and
    launches nothing: ``any_coincident.launches`` stays at 0."""
    monkeypatch.setattr(cuda_step.any_coincident, "launches", 0)
    for name, (x, y, m) in _coincidence_cases().items():
        t = [_t(a, np.float64) for a in (x, y, m)]
        got = cuda_step.any_coincident(*t)
        assert bool(got) == bool(cuda_step.any_coincident_reference(*t))
    assert cuda_step.any_coincident.launches == 0


def _hash_rule(x, y, m, dtype, order):
    """csrc/coincident.cu's insertion, one body at a time in ``order``:
    (flag, the longest probe past a body's home slot).  A body takes part
    if x and y are not NaN and its mass is > 0 or NaN; it claims the first
    empty slot from its hash, or stops at a holder at its position, and
    the flag fires there if either mass is > 0."""
    slots = cuda_step.coincident_slots(len(x))
    home = coincidence_hash(x, y, dtype) & np.uint64(slots - 1)
    table = np.zeros(slots, np.int64)
    flag, longest = False, 0
    for i in order:
        if np.isnan(x[i]) or np.isnan(y[i]) or not (m[i] > 0
                                                    or np.isnan(m[i])):
            continue
        s = int(home[i])
        for probe in range(slots):
            if table[s] == 0:
                table[s] = i + 1
                break
            j = table[s] - 1
            if x[j] == x[i] and y[j] == y[i]:
                flag = flag or m[i] > 0 or m[j] > 0
                break
            s = (s + 1) % slots
        longest = max(longest, probe)
    return flag, longest


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("case", sorted(COINCIDENCE_CASES))
def test_hash_rule_is_the_plain_version(case, dtype):
    """The kernel's rule, emulated in three insertion orders, gives the
    plain version's flag on every case of the card test, in every storage
    dtype; the "collide" cases chain COLLIDING_KEYS keys from one slot."""
    x, y, m = coincidence_cases(case, dtype)
    t = [_t(a, np.float64).to(getattr(torch, dtype)) for a in (x, y, m)]
    for a, b in zip(t, (x, y, m)):
        np.testing.assert_array_equal(_np(a.double()), b)
    want = bool(cuda_step.any_coincident_reference(*t))
    assert want == COINCIDENCE_CASES[case]
    n = len(x)
    orders = (range(n), range(n - 1, -1, -1),
              np.random.RandomState(1).permutation(n))
    for order in orders:
        flag, longest = _hash_rule(x, y, m, dtype, order)
        assert flag == want
        if case.startswith("collide"):
            assert longest >= COLLIDING_KEYS - 1


def test_coincident_slots_keep_the_table_three_quarters_empty():
    assert [cuda_step.coincident_slots(n) for n in (0, 1, 2, 3, 4, 5)] == \
        [2, 4, 8, 16, 16, 32]
    for n in (4095, 4096, 4097, 65536, 1048576, 26000000):
        slots = cuda_step.coincident_slots(n)
        assert slots & (slots - 1) == 0 and 4 * n <= slots < 8 * n


def test_coincident_launchers_match_the_source_in_their_own_library():
    """The flag's source belongs to the step library alone (``kernels``,
    where it compiles to its own object), and each launcher's ctypes
    signature is the C one: x, y, mass, n, the table, its slots, the flag
    and the stream."""
    import ctypes
    import re
    owners = [name for name, (files, _, _) in _build.LIBRARIES.items()
              if "coincident.cu" in files]
    assert owners == ["kernels"]
    sigs = {name: argtypes
            for name, argtypes in _build.LIBRARIES["kernels"][2].items()
            if name.startswith("nbody_any_coincident")}
    assert sorted(sigs) == ["nbody_any_coincident_%s" % s
                            for s in ("bf16", "f32", "f64")]
    with open(os.path.join(_build._CSRC, "coincident.cu")) as f:
        src = f.read()
    for name, argtypes in sigs.items():
        params = re.search(r"int %s\(([^)]*)\)" % name, src).group(1)
        types = [" ".join(p.split()[:-1]) for p in params.split(",")]
        assert [ctypes.c_void_p if t.endswith("*") else
                {"int64_t": ctypes.c_int64}[t] for t in types] == argtypes
