"""The port's rasterizer against the JAX package's, byte for byte.

The same host arrays (the glibc init, or made with numpy from a seed) go
through ``parallel_nbody_tpu.ops.render`` and
``parallel_nbody_tpu_torch.ops.render`` in fp64 and fp32; every comparison
is exact: both compute ``sqrt(dx*dx + dy*dy) <= radius + 0.5`` in the
bodies' dtype with one rounding per operation, and the tint is integer
arithmetic.  The cases are those of tests/test_render.py.  The reference
binary's own frame (tests_out/render_parity/ref_s3.ppm) is the external
oracle.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_nbody_tpu.config import SimConfig as JaxConfig
from parallel_nbody_tpu.models import engine as jengine
from parallel_nbody_tpu.ops import render as jrender
from parallel_nbody_tpu.state import init_state as jax_init_state
from parallel_nbody_tpu_torch.config import SimConfig
from parallel_nbody_tpu_torch.models.engine import run
from parallel_nbody_tpu_torch.ops import render as trender
from parallel_nbody_tpu_torch.state import init_state
from parallel_nbody_tpu_torch.utils import ppm
from parallel_nbody_tpu_torch.utils.output import format_state

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY = os.path.join(REPO, "tests_out", "render_parity")
DTYPES = ["float64", "float32"]


def _cfgs(dtype, xdim=64, ydim=48):
    kw = dict(xdim=xdim, ydim=ydim, force_mode="trig", dtype=dtype)
    return JaxConfig(**kw), SimConfig(**kw)


def _both(dtype, x, y, r, n_real, *chunking, xdim=64, ydim=48):
    """(JAX frame, port frame) of float64 host arrays cast to ``dtype``."""
    jcfg, cfg = _cfgs(dtype, xdim, ydim)
    host = [np.asarray(a, np.float64).astype(dtype) for a in (x, y, r)]
    want = np.asarray(jrender.render_frame(
        jcfg, *(jnp.asarray(a) for a in host), n_real, *chunking))
    got = trender.render_frame(
        cfg, *(torch.from_numpy(a) for a in host), n_real, *chunking)
    assert got.dtype == torch.uint8 and got.shape == (ydim, xdim, 3)
    return want, got.numpy()


def _tint(b, n):
    t = (0xFFF * (b + 1)) // (n + 2)
    return ((t & 0xF) << 4, t & 0xF0, (t & 0xF00) >> 4)


def _scattered(seed, n, xdim=64, ydim=48):
    """Non-integer positions and radii, some bodies partly outside the
    arena, so hit boundaries do not sit on round numbers."""
    rng = np.random.RandomState(seed)
    return (rng.uniform(-3, xdim + 3, n), rng.uniform(-3, ydim + 3, n),
            rng.uniform(0.3, 6.0, n))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [2, 12, 25])
def test_render_glibc_init_byte_equal(n, dtype):
    jcfg, _ = _cfgs(dtype)
    st = jax_init_state(n, jcfg)
    want, got = _both(dtype, st.x, st.y, st.radius, n)
    assert got.tobytes() == want.tobytes()
    flat = got.reshape(-1, 3)
    assert (flat == 0).all(axis=1).any() and flat.any()  # black and color


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_scattered_bodies_byte_equal(seed, dtype):
    x, y, r = _scattered(seed, 40)
    want, got = _both(dtype, x, y, r, 40)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", DTYPES)
def test_render_overlapping_bodies_first_wins(dtype):
    want, got = _both(dtype, [10.0, 10.0], [10.0, 10.0], [3.0, 5.0], 2)
    assert got.tobytes() == want.tobytes()
    assert tuple(got[10, 10]) == _tint(0, 2)
    # Outside body 0 but inside body 1 -> body 1's tint.
    assert tuple(got[10, 14]) == _tint(1, 2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_render_masks_padding_bodies(dtype):
    # Body 1 is padding; its huge radius must not leak.
    want, got = _both(dtype, [10.0, 20.0], [10.0, 20.0], [2.0, 50.0], 1)
    assert got.tobytes() == want.tobytes()
    assert tuple(got[20, 20]) == (0, 0, 0)
    assert tuple(got[10, 10]) != (0, 0, 0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_render_empty_arena_is_black(dtype):
    want, got = _both(dtype, [-50.0, 500.0], [-50.0, 500.0], [2.0, 2.0], 2)
    assert got.tobytes() == want.tobytes()
    assert not got.any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("row_block, body_chunk", [
    (32, 4), (32, 7), (32, 25), (32, 64), (5, 3), (48, None), (100, 1)])
def test_render_chunked_identical(row_block, body_chunk, dtype):
    """Any chunking of either axis gives the unchunked bytes, row blocks
    and body chunks that do not divide the frame included; the JAX frame
    under the same chunking is the same too."""
    jcfg, cfg = _cfgs(dtype)
    st = init_state(25, cfg)
    full = trender.render_frame(cfg, st.x, st.y, st.radius, 25, 48, 25)
    got = trender.render_frame(cfg, st.x, st.y, st.radius, 25, row_block,
                               body_chunk)
    assert torch.equal(got, full)
    want, _ = _both(dtype, st.x.numpy(), st.y.numpy(), st.radius.numpy(), 25,
                    row_block, body_chunk)
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", DTYPES)
def test_render_chunked_overlap_z_order(dtype):
    """Overlapping bodies in DIFFERENT chunks: smaller global index wins."""
    x, y = [10.0, 30.0, 50.0, 10.0], [10.0, 30.0, 40.0, 10.0]
    r = [3.0, 2.0, 2.0, 5.0]  # 0 and 3 overlap across chunks
    want, got = _both(dtype, x, y, r, 4, 32, 2)
    full, _ = _both(dtype, x, y, r, 4)
    assert got.tobytes() == want.tobytes() == full.tobytes()
    assert tuple(got[10, 10]) == _tint(0, 4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("row_block", [1, 8, 48])
def test_render_bodies_touching_a_row_block_s_edge(row_block, dtype):
    """render_frame keeps, per row block, only the bodies near enough to
    reach it.  Bodies whose disc ends exactly on the first or last row of a
    block (|dy| == radius + 0.5 at dx == 0), just short of it and just past
    it, above, below and outside the frame: the same bytes as the JAX
    package's unculled frame."""
    x = [5.0, 12.0, 19.0, 26.0, 33.0, 40.0, 47.0, 54.0, 60.0]
    y = [4.5, 4.5, 4.5, 11.5, 19.5, -3.0, 50.5, 47.49, 23.999]
    r = [3.0, 2.999, 3.001, 3.0, 3.0, 2.5, 2.0, 0.0, 7.501]
    want, got = _both(dtype, x, y, r, 9, row_block)
    assert got.tobytes() == want.tobytes()
    assert tuple(got[8, 5]) == _tint(0, 9)      # ends exactly on row 8
    assert tuple(got[8, 12]) == (0, 0, 0)       # just short of it
    assert tuple(got[8, 19]) == _tint(2, 9)


@pytest.mark.parametrize("row_block", [1, 8, 32])
def test_render_bf16_any_row_block_same_bytes(row_block):
    """bf16 rounds row coordinates above 512 to steps of 4, so a body can
    hit rows farther away than its radius: body 0 at y = 704 with radius
    0.3 hits rows 702..706, all of which round to 704.  The bound that
    keeps a body out of a row block allows for that rounding, and every row
    block gives the bytes of the frame taken as one block."""
    cfg = SimConfig(xdim=64, ydim=720, dtype="bfloat16")
    x, y, r = _scattered(11, 60, 64, 720)
    x = np.maximum(x, 24.0)  # column 10 is body 0's alone
    x[0], y[0], r[0] = 10.0, 704.0, 0.3
    b = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, y, r)]
    whole = trender.render_frame(cfg, *b, 60, 720)
    assert [int(i) for i in torch.nonzero(whole[:, 10].any(-1))[:, 0]] \
        == [702, 703, 704, 705, 706]
    assert torch.equal(trender.render_frame(cfg, *b, 60, row_block), whole)


def test_default_body_chunk_keeps_the_budget():
    """Left to render_frame, the body chunk is sized from the budget, the
    row block and the width alone, so the hit temporaries do not grow with
    N."""
    per_body = trender._chunk_bytes_per_body(32, 1024, torch.float32)
    assert per_body == 32 * 1024 * 5
    chunk = trender.HIT_BUDGET_BYTES // per_body
    assert chunk >= 1 and chunk * per_body <= trender.HIT_BUDGET_BYTES
    assert trender._chunk_bytes_per_body(32, 1024, torch.float64) \
        == 32 * 1024 * 9


@pytest.mark.parametrize("dtype", DTYPES)
def test_min_hit_index_rows_equal(dtype):
    x, y, r = (np.asarray(a).astype(dtype) for a in _scattered(5, 30))
    ys = np.arange(7, 19)
    want = np.asarray(jrender.min_hit_index_rows(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(r), jnp.asarray(ys), 64,
        base_idx=100))
    got = trender.min_hit_index_rows(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(r),
        torch.from_numpy(ys), 64, base_idx=100)
    assert got.dtype == torch.int32 and got.shape == (12, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert trender._NO_HIT == int(jrender._NO_HIT)
    hits = got[got != trender._NO_HIT]
    assert hits.numel() and int(hits.min()) >= 100


@pytest.mark.parametrize("n_real", [10_000, 524_288, 2_097_152, 10_000_000])
def test_tint_rgb_exact_at_large_indices(n_real):
    """The indices of tests/test_render.py's case of the same name: the
    port's int64 quotient, the JAX package's corrected fp32 estimate and
    the reference formula in numpy int64 agree."""
    rng = np.random.RandomState(n_real % 100003)
    idx = np.unique(np.concatenate([
        rng.randint(0, n_real, 64),
        [0, 1, 524287, 524288, n_real - 1][:5 if n_real > 524288 else 2],
    ])).astype(np.int64)
    idx = idx[idx < n_real]
    tint = (0xFFF * (idx + 1)) // (n_real + 2)
    oracle = np.stack([(tint & 0xF) << 4, tint & 0xF0, (tint & 0xF00) >> 4],
                      axis=-1).astype(np.uint8)
    want = np.asarray(jrender.tint_rgb(jnp.asarray(idx, jnp.int32), n_real))
    got = trender.tint_rgb(torch.from_numpy(idx.astype(np.int32)), n_real)
    np.testing.assert_array_equal(got.numpy(), oracle)
    np.testing.assert_array_equal(got.numpy(), want)


def test_tint_rgb_misses_stay_black():
    best = torch.tensor([[trender._NO_HIT, 0], [5_000_000, trender._NO_HIT]],
                        dtype=torch.int32)
    got = trender.tint_rgb(best, 10_000_000)
    assert got.shape == (2, 2, 3) and got.dtype == torch.uint8
    assert not got[0, 0].any() and not got[1, 1].any() and got[1, 0].any()


def test_tint_exactness_guard_matches_jax():
    """Both packages refuse n_real + 2 >= 2**29 and take the last count
    inside the bound."""
    best = torch.zeros(4, dtype=torch.int32)
    for tint, zeros in ((trender.tint_rgb, best),
                        (jrender.tint_rgb, jnp.zeros((4,), jnp.int32))):
        with pytest.raises(ValueError, match="2\\*\\*29"):
            tint(zeros, 1 << 29)
        assert tint(zeros, (1 << 29) - 3).shape == (4, 3)


# ---------------------------------------------------------------------------
# engine + rasterizer against the JAX package and the reference binary
# ---------------------------------------------------------------------------

def test_engine_frame_matches_jax_n2048():
    """N=2048, 3 steps of the fp64 trig engine on the 128x96 arena, then a
    frame: state printout and frame equal the JAX package's."""
    kw = dict(xdim=128, ydim=96, force_mode="trig", dtype="float64")
    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    jst = jengine.run(jcfg, jax_init_state(2048, jcfg), 3)
    st = run(cfg, init_state(2048, cfg), 3)
    from parallel_nbody_tpu.utils.output import format_state as jformat
    assert format_state(st) == jformat(jst)
    want = np.asarray(jrender.render_frame(jcfg, jst.x, jst.y, jst.radius,
                                           2048))
    got = trender.render_frame(cfg, st.x, st.y, st.radius, 2048)
    assert got.numpy().tobytes() == want.tobytes()
    assert got.any()


@pytest.mark.slow
def test_reference_binary_frame_n10000(tmp_path):
    """The reference binary's own frame: N=10000, 3 steps, fp64 trig on the
    128x96 arena (bin/render-parity.sh's configuration; every step outlasts
    secs_per_update=1 there, so the file holds the frame of the final
    state).  The port's printout equals ref_s3.out and its frame equals the
    pixel data of ref_s3.ppm.  Slow: 3 x 1e8 fp64 trig pairs on one core,
    with ~10 GB of pair matrices."""
    ref = ppm.read_header(os.path.join(PARITY, "ref_s3.ppm"))
    assert (ref.xdim, ref.ydim) == (128, 96)
    cfg = SimConfig(xdim=ref.xdim, ydim=ref.ydim, force_mode="trig",
                    dtype="float64")
    st = run(cfg, init_state(10000, cfg), 3)
    with open(os.path.join(PARITY, "ref_s3.out")) as f:
        assert format_state(st) == f.read()
    frame = trender.render_frame(cfg, st.x, st.y, st.radius, 10000).numpy()
    assert frame.tobytes() == ppm.read_pixels(ref).tobytes()
    # And through write_pixels into a fresh arena: the whole file's bytes.
    mine = ppm.create(str(tmp_path / "mine.ppm"), ref.xdim, ref.ydim)
    ppm.write_pixels(mine, frame)
    with open(mine.path, "rb") as a, open(ref.path, "rb") as b:
        assert a.read() == b.read()


# ---------------------------------------------------------------------------
# write_pixels / read_pixels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("native", [True, False])
def test_write_read_pixels_round_trip(native, tmp_path, monkeypatch):
    """In-place frame update through the native blit and through the
    seek+write path behind it: same file bytes as the JAX package's."""
    import parallel_nbody_tpu.utils.ppm as jppm
    from parallel_nbody_tpu_torch.utils import native_bridge
    if native:
        assert native_bridge.available()
    else:
        monkeypatch.setattr(native_bridge, "ppm_blit", lambda *a: False)
    rng = np.random.RandomState(9)
    frame = rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
    p = str(tmp_path / "a.ppm")
    with open(p, "wb") as f:
        f.write(b"P6\n# a comment\n64 48\n255\n" + bytes(64 * 48 * 3))
    handle = ppm.read_header(p)
    ppm.write_pixels(handle, frame)
    np.testing.assert_array_equal(ppm.read_pixels(handle), frame)
    q = str(tmp_path / "b.ppm")
    with open(q, "wb") as f:
        f.write(b"P6\n# a comment\n64 48\n255\n" + bytes(64 * 48 * 3))
    jppm.write_pixels(jppm.read_header(q), frame)
    with open(p, "rb") as a, open(q, "rb") as b:
        assert a.read() == b.read()
    with pytest.raises(ValueError, match="does not fit"):
        ppm.write_pixels(handle, frame[:10])
