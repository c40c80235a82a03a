"""The symmetric pass of the square fp32 case on the CPU: its plain version
(``ops.cuda_step.symmetric_partials``, ``block_forces_symmetric_reference``)
against K1's plain version, its row launches' plain version
(``symmetric_row_partials``, ``symmetric_forces_reference``) against the
one launch's, the dispatch that chooses it (``takes_symmetric``), the
programs that hand it one block of bodies, and the census of its loops.
Imports no JAX.

Tolerances and why:
  - against ``block_forces_reference``: the same pair terms summed in
    another order (a tile pair's sums, then the tile slots in tile order,
    where K1 folds 128-wide tile partials in order), so 2e-6 * max|F| in
    fp32, the kernels' bound (tests/test_torch_gpu.py), measured below
    2.3e-7.
  - the kick of a coincident pair, every other body massless and far: no
    tolerance; each body's force is one term, K1's own, exactly.
  - a slot against its tile's one-sided sum in fp64: 1e-13 relative (the
    same terms, summed in another order).
"""

import os
import re

import numpy as np
import pytest
import torch

from parallel_nbody_tpu_torch.benchmarks import sass_census
from parallel_nbody_tpu_torch.config import SimConfig
from parallel_nbody_tpu_torch.ops import cuda_step
from parallel_nbody_tpu_torch.parallel import emulate, grid2d, sharded_step
from parallel_nbody_tpu_torch.state import init_state, pad_state, random_state
from torch_cases import KICK, KICK_PLACEMENTS, blocks, glibc_like, kick_case

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "parallel_nbody_tpu_torch", "csrc")
TOL = 2e-6


def _cfg(dtype="float32"):
    return SimConfig(force_mode="fast", dtype=dtype, kernel="cuda")


def _t(arrays, dtype=torch.float32):
    return [torch.tensor(a, dtype=dtype) for a in arrays]


def _square(case):
    """(x, y, mass, radius) fp32 tensors of one block of bodies."""
    if case == "ragged384":
        return _t(glibc_like(384, 31, ((10, 20), (3, 383), (100, 300))))
    if case == "ragged4097":
        return _t(glibc_like(4097, 32, ((5, 4000), (511, 512),
                                        (1023, 1024))))
    if case == "far_padding":
        st, _ = pad_state(init_state(1000, _cfg()), 1152)
        return [st.x, st.y, st.mass, st.radius]
    if case == "zero_mass":
        return _t(blocks("zero_mass")[0])
    raise ValueError(case)


SQUARE_CASES = ("ragged384", "ragged4097", "far_padding", "zero_mass")


@pytest.mark.parametrize("biased", [True, False, "flag"])
@pytest.mark.parametrize("case", SQUARE_CASES)
def test_symmetric_plain_matches_k1_plain(case, biased):
    b = _square(case)
    if biased == "flag":
        biased = torch.ones((), dtype=torch.bool)
    cfg = _cfg()
    want = cuda_step.block_forces_reference(cfg, *b, *b, biased=biased)
    got = cuda_step.block_forces_symmetric_reference(cfg, *b, biased=biased)
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert float((g - w).abs().max()) <= TOL * scale


@pytest.mark.parametrize("name", sorted(KICK_PLACEMENTS))
def test_symmetric_plain_kick_is_k1_kick(name):
    """The placement's row block against itself (so at row_g0 = 37 the
    128-row blocks start off the multiples of 128): each body of the
    coincident pair gets K1's kick bit for bit, with opposite signs."""
    rows, _, r0, _, (ia, ib) = kick_case(name)
    b = _t(rows)
    cfg = _cfg()
    want = cuda_step.block_forces_reference(cfg, *b, *b, row_g0=r0,
                                            col_g0=r0, biased=True)
    got = cuda_step.block_forces_symmetric_reference(cfg, *b, biased=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    xf, yf = got
    np.testing.assert_allclose([float(xf[ia]), float(xf[ib])], [KICK, -KICK],
                               rtol=1e-6)
    assert not bool(yf.any())


def test_symmetric_plain_far_padding_is_exactly_zero():
    xf, yf = cuda_step.block_forces_symmetric_reference(
        _cfg(), *_square("far_padding"), biased=True)
    assert not bool(xf[1000:].any()) and not bool(yf[1000:].any())
    assert bool(torch.isfinite(xf).all()) and bool(xf[:1000].any())


@pytest.mark.parametrize("n, tile", [(1100, 512), (700, 128), (300, 512)])
def test_symmetric_slots_are_tile_sums(n, tile):
    """Slot [K, :, b] is body b's raw acceleration from tile K's bodies: the
    one-sided sum of K1's terms over that tile, whoever wrote it (row tile
    below, the diagonal, or the column side of a tile pair)."""
    x, y, m, r = _t(glibc_like(n, 33, ((1, 650 % n), (2, 3))), torch.float64)
    ws = cuda_step.symmetric_partials(x, y, m, r, biased=True, tile=tile)
    assert ws.shape == (-(-n // tile), 2, n)
    bias = cuda_step.dx_bias(range(n), n, row_g0=0, col_g0=0,
                             row_block=cuda_step.TILE, tile=cuda_step.TILE,
                             dtype=torch.float64)
    dx = (x[None, :] - x[:, None]) + bias
    dy = y[None, :] - y[:, None]
    dsqr = dx * dx + dy * dy
    mind = r[:, None] + r[None, :]
    forced = torch.maximum(dsqr, mind * mind)
    s = m[None, :] * torch.rsqrt(forced * forced * dsqr + 1e-200)
    for k in range(ws.shape[0]):
        cols = slice(k * tile, (k + 1) * tile)
        for c, d in ((0, dx), (1, dy)):
            want = (s[:, cols] * d[:, cols]).sum(1)
            np.testing.assert_allclose(ws[k, c].numpy(), want.numpy(),
                                       rtol=0, atol=1e-13
                                       * float(want.abs().max()))


def test_block_forces_on_the_cpu_keeps_k1_order():
    b = _square("ragged384")
    before = cuda_step.block_forces.symmetric_launches
    got = cuda_step.block_forces(_cfg(), *b, *b, biased=True)
    want = cuda_step.block_forces_reference(_cfg(), *b, *b, biased=True)
    one_sided = cuda_step.block_forces_one_sided(_cfg(), *b, *b, biased=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(one_sided, want))
    assert cuda_step.block_forces.symmetric_launches == before


def _dispatch_case(case):
    """(dtype, m, k, keywords) for takes_symmetric."""
    top = cuda_step.STREAMED_ABOVE
    kw = dict(row_g0=0, col_g0=0, accum="plain")
    return {
        "square_fp32": (torch.float32, 384, 384, kw),
        "square_bf16": (torch.bfloat16, 384, 384, kw),
        "fp64": (torch.float64, 384, 384, kw),
        "compensated": (torch.float32, 384, 384,
                        dict(kw, accum="compensated")),
        "off_diagonal": (torch.float32, 384, 384, dict(kw, col_g0=128)),
        "equal_offsets_not_zero": (torch.float32, 384, 384,
                                   dict(kw, row_g0=37, col_g0=37)),
        "row_slice": (torch.float32, 256, 384, kw),
        "top_of_k1_range": (torch.float32, top, top, kw),
        "past_k1_range": (torch.float32, top + 128, top + 128, kw),
        "past_k1_range_fp64": (torch.float64, top + 128, top + 128, kw),
        "past_k1_range_compensated": (torch.float32, top + 128, top + 128,
                                      dict(kw, accum="compensated")),
        "past_k1_range_row_slice": (torch.float32, 65536, top + 128, kw),
        "past_k1_range_unequal_offsets": (torch.float32, top + 128,
                                          top + 128, dict(kw, col_g0=512)),
    }[case]


@pytest.mark.parametrize("case, want", [
    ("square_fp32", True), ("square_bf16", True), ("fp64", False),
    ("compensated", False), ("off_diagonal", False),
    ("equal_offsets_not_zero", True), ("row_slice", False),
    ("top_of_k1_range", True), ("past_k1_range", True),
    ("past_k1_range_fp64", False), ("past_k1_range_compensated", False),
    ("past_k1_range_row_slice", False),
    ("past_k1_range_unequal_offsets", False)])
def test_takes_symmetric(case, want):
    """The rule holds at any N: past K1's range it sends the square fp32
    call to ``symmetric_forces`` in place of K2, and leaves fp64,
    compensated sums, row slices and blocks at other offsets to K2."""
    dtype, m, k, kw = _dispatch_case(case)
    assert cuda_step.takes_symmetric(dtype, m, k, **kw) is want


def test_k1_range_workspace_fits_k2_budget():
    """The one-launch layout, (tiles, 2, N) fp32, is 256 MiB at
    STREAMED_ABOVE and 1 GiB at 262144, within K2's budget, where
    ``symmetric_row_tiles`` takes all rows in one launch; at N=1M it would
    be 16 GiB, and the row launches of 65 tiles keep the first, largest,
    launch's two workspaces (own bodies' slots, later bodies' slots) within
    the budget, in 32 launches."""
    tile = cuda_step.SYMMETRIC_TILE

    def ws_bytes(n):
        return -(-n // tile) * 2 * n * 4

    def first_launch_bytes(n, tiles):
        rows = min(n, tiles * tile)
        return 8 * (-(-n // tile) * rows + tiles * (n - rows))

    budget = cuda_step.K2_WORKSPACE_BYTES
    top = cuda_step.STREAMED_ABOVE
    assert ws_bytes(top) == 1 << 28 <= budget
    assert cuda_step.symmetric_row_tiles(top) == top // tile
    assert ws_bytes(1 << 18) == budget
    assert cuda_step.symmetric_row_tiles(1 << 18) == (1 << 18) // tile
    assert ws_bytes(1 << 20) == 16 << 30
    tiles = cuda_step.symmetric_row_tiles(1 << 20)
    assert tiles == 65 and -(-(1 << 20) // tile // tiles) == 32
    assert first_launch_bytes(1 << 20, tiles) <= budget \
        < first_launch_bytes(1 << 20, tiles + 1)


@pytest.mark.parametrize("budget, n, want", [
    (1 << 26, 131072 + 77, 34), (4 << 20, 2600, 6), (40000, 2600, 1),
    (1, 1537, 1)])
def test_symmetric_row_tiles_follow_the_budget(budget, n, want,
                                               monkeypatch):
    """The rows a launch takes come from K2_WORKSPACE_BYTES, so a lowered
    budget forces several launches (at least one tile each)."""
    monkeypatch.setattr(cuda_step, "K2_WORKSPACE_BYTES", budget)
    assert cuda_step.symmetric_row_tiles(n) == want


@pytest.mark.parametrize("n, tiles", [(1537, 1), (1537, 2), (1537, 4),
                                      (2600, 3), (131072 + 77, 34),
                                      (1 << 20, 65), (1 << 20, 2048)])
def test_launch_bytes_set_the_row_tiles(n, tiles, monkeypatch):
    """A budget of ``symmetric_launch_bytes(n, tiles)`` gives launches of
    exactly ``tiles`` row tiles, and a byte less gives fewer: how the tests
    and the smoke choose the launches, the budget being the one setting."""
    budget = cuda_step.symmetric_launch_bytes(n, tiles)
    monkeypatch.setattr(cuda_step, "K2_WORKSPACE_BYTES", budget)
    assert cuda_step.symmetric_row_tiles(n) == tiles
    monkeypatch.setattr(cuda_step, "K2_WORKSPACE_BYTES", budget - 1)
    assert cuda_step.symmetric_row_tiles(n) == max(1, tiles - 1)


def _launch_tiles(monkeypatch, n, tiles):
    """Set K2_WORKSPACE_BYTES so that ``symmetric_forces`` over ``n`` bodies
    takes ``tiles`` row tiles a launch ("all": one launch)."""
    nt = -(-n // cuda_step.SYMMETRIC_TILE)
    tiles = nt if tiles == "all" else tiles
    monkeypatch.setattr(cuda_step, "K2_WORKSPACE_BYTES",
                        cuda_step.symmetric_launch_bytes(n, tiles))
    assert cuda_step.symmetric_row_tiles(n) == tiles


def _row_case(n, biased):
    b = _t(glibc_like(n, 34, ((3, n - 2), (511, 512), (600, 1100))))
    if biased in ("flag_true", "flag_false"):
        biased = torch.tensor(biased == "flag_true")
    return b, biased


@pytest.mark.parametrize("row_tiles", [1, 2, "all"])
@pytest.mark.parametrize("biased", [True, False, "flag_true", "flag_false"])
@pytest.mark.parametrize("n", [1537, 2600])
def test_symmetric_row_launches_plain_is_one_launch(n, biased, row_tiles,
                                                    monkeypatch):
    """The row launches' plain version folds each body's slots in tile
    order across launches: bit for bit the one launch's forces
    (``block_forces_symmetric_reference``), with one tile a launch,
    several, or all (as K2_WORKSPACE_BYTES sets them), at ragged N with
    coincident pairs."""
    b, biased = _row_case(n, biased)
    cfg = _cfg()
    want = cuda_step.block_forces_symmetric_reference(cfg, *b, biased=biased)
    _launch_tiles(monkeypatch, n, row_tiles)
    got = cuda_step.symmetric_forces_reference(cfg, *b, biased=biased)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("t0, t1", [(0, 1), (0, 3), (1, 3), (2, 6), (5, 6),
                                    (0, 6)])
def test_symmetric_row_partials_are_the_one_launch_slots(t0, t1):
    """A row launch's two workspaces hold the one-launch workspace's slots:
    ``own`` those of its bodies from tile t0 on, ``beyond`` those of the
    later bodies over its row tiles."""
    x, y, m, r = _t(glibc_like(2600, 35, ((1, 2000),)))
    tile = cuda_step.SYMMETRIC_TILE
    ws = cuda_step.symmetric_partials(x, y, m, r, biased=True)
    own, beyond = cuda_step.symmetric_row_partials(x, y, m, r, biased=True,
                                                   t0=t0, t1=t1)
    r0, r1 = t0 * tile, min(2600, t1 * tile)
    assert torch.equal(own, ws[t0:, :, r0:r1])
    assert torch.equal(beyond, ws[t0:t1, :, r1:])


def test_symmetric_forces_on_the_cpu_is_its_plain_version(monkeypatch):
    """On CPU tensors ``symmetric_forces`` runs its plain version, in the
    launches the budget sets, counts nothing, and takes fp32 compute
    only."""
    b, _ = _row_case(2600, True)
    _launch_tiles(monkeypatch, 2600, 2)
    before = cuda_step.symmetric_forces.launches
    got = cuda_step.symmetric_forces(_cfg(), *b, biased=True)
    want = cuda_step.block_forces_symmetric_reference(_cfg(), *b,
                                                      biased=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert cuda_step.symmetric_forces.launches == before
    b16 = [t.to(torch.bfloat16) for t in b]
    got = cuda_step.symmetric_forces(_cfg("bfloat16"), *b16, biased=True)
    assert all(g.dtype == torch.bfloat16 for g in got)
    with pytest.raises(TypeError):
        cuda_step.symmetric_forces(_cfg("float64"),
                                   *[t.double() for t in b], biased=True)


def test_block_forces_auto_on_the_cpu_keeps_k2_past_the_range(monkeypatch):
    """Past STREAMED_ABOVE the square fp32 call on CPU tensors is still
    K2's plain version, bit for bit, as before the symmetric pass took
    that call on the card."""
    monkeypatch.setattr(cuda_step, "STREAMED_ABOVE", 1024)
    b, _ = _row_case(1537, True)
    cfg = _cfg()
    got = cuda_step.block_forces_auto(cfg, *b, *b, biased=True)
    want = cuda_step.block_forces_streamed_reference(cfg, *b, *b,
                                                     biased=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("layout, want", [
    (("allgather", 1), [True]), (("ring", 1), [True]),
    (("grid2d", 1, 1), [True]), (("allgather", 2), [False, False]),
    (("ring", 2), [True, False, True, False]),
    (("grid2d", 2, 1), [True, False, False, True]),
    (("grid2d", 2, 2), [False] * 8)])
def test_programs_hand_one_block_to_the_kernel(layout, want, monkeypatch):
    """Every rank's kernel calls, in rank order: the all-gather program at
    world size 1, a ring rank's hop 0 and a column-1 grid's diagonal cells
    show one block against itself (equal lengths at equal offsets), which
    the symmetric pass takes, and there the columns are the rows' bodies;
    every other call is K1's."""
    seen = []

    def record(cfg, *args, **kw):
        sym = cuda_step.takes_symmetric(
            args[0].dtype, args[0].shape[0], args[4].shape[0],
            row_g0=kw["row_g0"], col_g0=kw["col_g0"], accum=kw["accum"])
        if sym:
            assert all(torch.equal(r, c) for r, c in zip(args[:4], args[4:]))
        seen.append(sym)
        return cuda_step.block_forces_auto(cfg, *args, **kw)

    monkeypatch.setattr(sharded_step, "block_forces_auto", record)
    monkeypatch.setattr(grid2d, "block_forces_auto", record)
    cfg = _cfg()
    st = random_state(256, cfg, torch.Generator().manual_seed(3))
    whole = cuda_step.block_forces_reference(
        cfg, st.x, st.y, st.mass, st.radius, st.x, st.y, st.mass, st.radius,
        biased=False)
    got = emulate.combine([p() for p in emulate.rank_programs(cfg, st,
                                                               layout)],
                          layout)
    assert seen == want
    for g, w in zip(got, whole):
        assert float((g - w).abs().max()) <= TOL * float(w.abs().max())


def _constants(name):
    with open(os.path.join(CSRC, name)) as f:
        text = f.read()
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}


def test_layout_constants_match_the_source():
    """SYMMETRIC_TILE (the workspace's tile) and the census's pass are
    kThreads * kRows and kSub by kRows of csrc/forces_symmetric.cu."""
    k = _constants("forces_symmetric.cu")
    assert cuda_step.SYMMETRIC_TILE == k["kThreads"] * k["kRows"]
    assert cuda_step.SYMMETRIC_TILE % _constants("pairs.cuh")["kBlock"] == 0
    assert (sass_census.SYMMETRIC_COLUMNS, sass_census.SYMMETRIC_ROWS) == (
        k["kSub"], k["kRows"])


def _symmetric_listing(loops, nested_at=None,
                       kernel="block_forces_symmetric_kernel"):
    """A listing of a symmetric kernel's fp32 instantiation whose loops
    hold the given opcodes (each with an LDS.128 and its backward branch,
    a barrier between them); ``nested_at`` wraps the loops from that index
    on in an outer loop without a barrier, as the diagonal's loop over its
    row and column blocks is."""
    lines = ["\tFunction : _ZN53_GLOBAL__N__1_forces_symmetric_cu_a1b2c3d4"
             "%d%sIfEEvPKT_" % (len(kernel), kernel)]
    addr, outer = 0, None
    for k, body in enumerate(loops):
        if k == nested_at:
            outer = addr
            lines.append("        /*%04x*/ MOV R2, R3 ;" % addr)
            addr += 0x10
        start = addr
        for op in ["LDS.128 R8, [UR4]"] + body + ["@P1 BRA 0x%x" % start]:
            lines.append("        /*%04x*/ %s ;" % (addr, op))
            addr += 0x10
        if outer is None:
            lines.append("        /*%04x*/ BAR.SYNC.DEFER_BLOCKING 0x0 ;"
                         % addr)
            addr += 0x10
    if outer is not None:
        lines.append("        /*%04x*/ @P2 BRA 0x%x ;" % (addr, outer))
    return "\n".join(lines)


@pytest.mark.parametrize("kernel", sass_census.SYMMETRIC_KERNELS)
def test_sass_census_tells_the_symmetric_loops_apart(kernel):
    """Each symmetric kernel's (one launch, row launches) two loops with
    shuffles count 64 pairs a pass (8 columns by 8 rows) and are told apart
    by length; its diagonal's three K1 loops, nested in a loop without a
    barrier, count 8 and keep K1's roles; the outer loop is no inner
    loop."""
    shfl = ["SHFL.BFLY PT, R3, R4, 0x4, 0x1f", "FSEL R3, R4, R5, P0",
            "MUFU.RSQ R4, R7"]
    sym_const = shfl + ["FADD R9, R9, R5"]
    per_pair = ["I2FP.F32.S32 R3, R3", "FADD R9, -R3, R9",
                "FFMA R9, R3, R4, R9", "MUFU.RSQ R4, R7"]
    const = ["FADD R9, -R3, R9", "FADD R9, R9, R5", "MUFU.RSQ R4, R7"]
    unbiased = ["FADD R9, -R3, R9", "MUFU.RSQ R4, R7"]
    rows = sass_census.census(_symmetric_listing(
        [sym_const, shfl, unbiased, per_pair, const], nested_at=2,
        kernel=kernel))
    assert [r[0] for r in rows] == [kernel + "<f>"] * 5
    assert [r[3] for r in rows] == [64, 64, 8, 8, 8]
    roles = sass_census.loop_roles(rows)
    assert [roles[r[0], r[1]] for r in rows] == [
        "symmetric constant bias", "symmetric unbiased", "unbiased",
        "per-pair bias", "constant bias"]
    assert sass_census.instr_per_pair(rows[0]) == 6 / 64
