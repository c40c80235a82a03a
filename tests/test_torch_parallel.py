"""The port's distributed programs against the JAX package, in one process:
the dense block forces, the tagged coincidence test, every rank's force
computation (``parallel.emulate``: each rank's inputs cut from the full
padded state) against the JAX sharded runs on the 8 virtual devices, the
parallel CSV row, the mesh messages and the directory checkpoint.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: the dense trig and fast block forces in fp64 within
1e-14 * max|F| (torch's atan2/cos/sin differ from XLA's by at most 1 ulp,
and ``torch.sum`` sums in another order than XLA); the kernel path's plain
versions at the JAX geometry (1024-row blocks against 1024-wide tiles, as
``pallas_block_forces`` clamps them) against the Pallas kernel in interpret
mode within 1e-13 * max|F| in fp64 (the same tile partials, folded in the
same order; the grid's all-reduce over four ranks may add in another
order).  Every other comparison is exact.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_nbody_tpu.ops.forces as jforces
import parallel_nbody_tpu.ops.pallas_step as jpallas
import parallel_nbody_tpu.utils.output as joutput
from parallel_nbody_tpu.config import SimConfig as JaxConfig
from parallel_nbody_tpu.parallel.grid2d import (make_grid2d_run as jgrid_run,
                                                make_mesh2d as jmesh2d,
                                                shard_state_2d as jshard2d)
from parallel_nbody_tpu.parallel.mesh import make_mesh as jmesh
from parallel_nbody_tpu.parallel.mesh import shard_state as jshard
from parallel_nbody_tpu.parallel.sharded_step import \
    make_sharded_run as jsharded_run
from parallel_nbody_tpu.state import State as JState
from parallel_nbody_tpu.state import init_state as jinit
from parallel_nbody_tpu.state import pad_state as jpad
from parallel_nbody_tpu_torch.config import SimConfig
from parallel_nbody_tpu_torch.ops import cuda_step
from parallel_nbody_tpu_torch.ops import forces as tforces
from parallel_nbody_tpu_torch.parallel import emulate, grid2d, sharded_step
from parallel_nbody_tpu_torch.parallel.mesh import check_mesh_fits
from parallel_nbody_tpu_torch.state import State
from parallel_nbody_tpu_torch.utils import checkpoint as ckpt
from parallel_nbody_tpu_torch.utils import output as toutput
from parallel_nbody_tpu_torch.utils.convert import state_from_numpy
from torch_cases import glibc_like

torch.set_num_threads(1)

TOL_DENSE = 1e-14
TOL_KERNEL = 1e-13


def _t(arrays):
    return [torch.from_numpy(np.asarray(a, np.float64)) for a in arrays]


def _j(arrays):
    return [jnp.asarray(np.asarray(a, np.float64)) for a in arrays]


def _close(got, want, rel, label=""):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=rel * np.abs(w).max(), err_msg=label)


# ---------------------------------------------------------------------------
# ops/forces: the dense block paths of the sharded programs
# ---------------------------------------------------------------------------

def _strided_groups(n=240, pr=3, pc=2, my_r=1, my_c=1, seed=11):
    """Row and col groups of rank (my_r, my_c) on a pr x pc grid over an
    n-body glibc-like set with coincident pairs inside and across the
    groups, and their global ids (the col group is strided)."""
    full = glibc_like(n, seed, ((10, 130), (45, 50), (200, 215), (90, 170)))
    blk = n // (pr * pc)
    gid_row = my_r * blk * pc + np.arange(blk * pc)
    gid_col = ((np.arange(pr)[:, None] * pc + my_c) * blk
               + np.arange(blk)[None, :]).reshape(-1)
    return ([a[gid_row] for a in full], [a[gid_col] for a in full], gid_row,
            gid_col)


@pytest.mark.parametrize("mode", ["trig", "fast"])
def test_cross_block_with_explicit_gids(mode):
    rows, cols, gi, gj = _strided_groups()
    cfg, jcfg = SimConfig(force_mode=mode), JaxConfig(force_mode=mode)
    gids_t = (torch.from_numpy(gi), torch.from_numpy(gj))
    gids_j = (jnp.asarray(gi, jnp.int32), jnp.asarray(gj, jnp.int32))
    if mode == "trig":
        got = tforces._trig_cross_block(cfg, *_t(rows), *_t(cols), 0, 0,
                                        gids=gids_t)
        want = jforces._trig_cross_block(jcfg, *_j(rows), *_j(cols), 0, 0,
                                         gids=gids_j)
    else:
        x, y, m, r = _t(rows)
        xj, yj, mj, rj = _t(cols)
        got = tforces._forces_fast_block(cfg, x, y, m, xj, yj, mj, r, rj, 0,
                                         0, gids=gids_t)
        x, y, m, r = _j(rows)
        xj, yj, mj, rj = _j(cols)
        want = jforces._forces_fast_block(jcfg, x, y, m, xj, yj, mj, r, rj,
                                          0, 0, gids=gids_j)
    _close(got, want, TOL_DENSE)


def test_pair_sign_with_gids_is_exact():
    _, _, gi, gj = _strided_groups()
    got = tforces._pair_sign(torch.float64, "cpu", 0, 0, 0, 0,
                             (torch.from_numpy(gi), torch.from_numpy(gj)))
    want = jforces._pair_sign(jnp.float64, 0, 0, 0, 0,
                              (jnp.asarray(gi), jnp.asarray(gj)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int((got == 0).sum()) == len(set(gi) & set(gj))


def test_trig_cross_block_force_mask():
    full = glibc_like(200, 12, ((3, 150), (60, 61)))
    rows = [a[50:100] for a in full]
    mask = np.zeros((50, 200), bool)
    mask[:, 50:100] = True
    mask[7, 140:160] = True
    cfg, jcfg = SimConfig(), JaxConfig()
    got = tforces._trig_cross_block(cfg, *_t(rows), *_t(full), 50, 0,
                                    force_mask=torch.from_numpy(mask))
    want = jforces._trig_cross_block(jcfg, *_j(rows), *_j(full), 50, 0,
                                     force_mask=jnp.asarray(mask))
    _close(got, want, TOL_DENSE)


@pytest.mark.parametrize("mode", ["trig", "fast"])
@pytest.mark.parametrize("offset", [0, 60, 140])
def test_forces_block_vs_full(mode, offset):
    full = glibc_like(200, 13, ((5, 100), (70, 80), (150, 199)))
    blk = [a[offset:offset + 60] for a in full]
    cfg, jcfg = SimConfig(force_mode=mode), JaxConfig(force_mode=mode)
    got = tforces.forces_block_vs_full(cfg, *_t(blk), *_t(full), offset)
    want = jforces.forces_block_vs_full(jcfg, *_j(blk), *_j(full), offset)
    _close(got, want, TOL_DENSE)


@pytest.mark.parametrize("mode", ["trig", "fast"])
@pytest.mark.parametrize("same", [True, False])
def test_forces_on_block(mode, same):
    full = glibc_like(160, 14, ((5, 100), (20, 30)))
    own = [a[:80] for a in full]
    visit = own if same else [a[80:] for a in full]
    gj0 = 0 if same else 80
    cfg, jcfg = SimConfig(force_mode=mode), JaxConfig(force_mode=mode)
    got = tforces.forces_on_block(cfg, *_t(own), *_t(visit), same, 0, gj0)
    want = jforces.forces_on_block(jcfg, *_j(own), *_j(visit), same, 0, gj0)
    _close(got, want, TOL_DENSE)


# ---------------------------------------------------------------------------
# any_coincident_tagged
# ---------------------------------------------------------------------------

def _tagged_cases():
    rng = np.random.RandomState(3)
    x, y = rng.uniform(0, 100, 64), rng.uniform(0, 100, 64)
    m, gid = rng.uniform(1, 2, 64), np.arange(64)
    cases = {"distinct positions": (x, y, m, gid)}
    # Every body twice (a ring rank's own block visiting itself).
    cases["copies of one body"] = tuple(np.concatenate([a, a])
                                        for a in (x, y, m, gid))
    x2, y2 = x.copy(), y.copy()
    x2[40], y2[40] = x[7], y[7]
    cases["two massive bodies"] = (x2, y2, m, gid)
    m3 = m.copy()
    m3[40] = 0.0
    cases["massive and massless"] = (x2, y2, m3, gid)
    cases["massless and massive copies"] = tuple(
        np.concatenate([a, a]) for a in (x2, y2, m3, gid))
    x4, y4 = x.copy(), y.copy()
    x4[3], y4[3], x4[9], y4[9] = 0.0, -0.0, -0.0, 0.0
    cases["signed zeros"] = (x4, y4, m, gid)
    # Padding at one far coordinate: massless, distinct ids.
    xp = np.concatenate([x, np.full(8, 1e9)])
    yp = np.concatenate([y, np.full(8, 1e9)])
    cases["padding"] = (xp, yp, np.concatenate([m, np.zeros(8)]),
                        np.arange(72))
    return cases


TAGGED = _tagged_cases()


@pytest.mark.parametrize("case", sorted(TAGGED))
def test_any_coincident_tagged_matches_jax(case):
    x, y, m, gid = TAGGED[case]
    got = cuda_step.any_coincident_tagged(*_t((x, y, m)),
                                          torch.from_numpy(gid))
    want = jpallas.any_coincident_tagged(*_j((x, y, m)),
                                         jnp.asarray(gid, jnp.int32))
    assert got.dim() == 0 and got.dtype == torch.bool
    assert bool(got) == bool(want)
    expect = case in ("two massive bodies", "signed zeros")
    assert bool(got) == expect


def test_tagged_equals_untagged_on_one_copy():
    """On a block without copies (world size 1: own block == visiting
    block, both tagged alike) the tagged flag is ``any_coincident``'s."""
    for seed in range(4):
        x, y, m, _ = glibc_like(500, seed)
        # Off the integer pixels, so only the planted pair can coincide.
        x = x + np.random.RandomState(seed).uniform(0.1, 0.9, 500)
        if seed % 2:
            x[2], y[2] = x[1], y[1]
        t = _t((x, y, m))
        gid = torch.arange(500)
        both = [torch.cat([a, a]) for a in t]
        assert bool(cuda_step.any_coincident_tagged(
            *both, torch.cat([gid, gid]))) == \
            bool(cuda_step.any_coincident(*t)) == bool(seed % 2)


def test_coincidence_flags_sort_three_times(monkeypatch):
    """Each flag's sort (``any_coincident``'s plain version, and the tagged
    flag on every device) is one stable sort per key (three), every step of
    every rank: a fourth would cost a step on the card more than the flag's
    whole GPU time."""
    calls = []
    real = torch.sort

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(torch, "sort", counting)
    x = torch.rand(64, dtype=torch.float64)
    cuda_step.any_coincident(x, x, x)
    assert len(calls) == 3
    cuda_step.any_coincident_tagged(x, x, x, torch.arange(64))
    assert len(calls) == 6


# ---------------------------------------------------------------------------
# every rank's force computation against the JAX sharded runs
# ---------------------------------------------------------------------------

N = 100
LAYOUTS = ([("allgather", p) for p in (1, 2, 4, 8)]
           + [("ring", p) for p in (1, 2, 4, 8)]
           + [("grid2d", 1, 2), ("grid2d", 2, 2), ("grid2d", 2, 4)])


def _initial(n, cfg_kw):
    """The glibc init with coincident pairs planted inside a shard and
    across shard boundaries, as numpy fields."""
    st = jinit(n, JaxConfig(**cfg_kw))
    f = {k: np.array(v) for k, v in st._asdict().items()}
    for a, b in ((10, 60), (30, 31), (5, n - 1)):
        f["x"][b], f["y"][b] = f["x"][a], f["y"][a]
    return f


def _jax_forces(jcfg, fields, layout, pad):
    st, n_real = jpad(JState(*(jnp.asarray(fields[k])
                               for k in JState._fields)), pad)
    if layout[0] == "grid2d":
        mesh = jmesh2d(layout[1], layout[2])
        out = jgrid_run(jcfg, mesh, 1)(jshard2d(st, mesh))
    else:
        mesh = jmesh(layout[1])
        out = jsharded_run(jcfg, mesh, 1, layout[0])(jshard(st, mesh))
    return st, np.asarray(out.xf), np.asarray(out.yf)


def _port_state(jst):
    return state_from_numpy({k: np.asarray(v) for k, v in
                             jst._asdict().items()}, dtype=torch.float64)


@pytest.mark.parametrize("mode", ["trig", "fast"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: "x".join(map(
    str, l[1:])) + "-" + l[0])
def test_rank_forces_match_jax_sharded_run(layout, mode):
    """One step of the JAX sharded run (N=100 padded to the ranks) against
    every rank's force function called here and put together."""
    kw = dict(force_mode=mode, dtype="float64")
    fields = _initial(N, kw)
    jst, xf, yf = _jax_forces(JaxConfig(**kw), fields, layout,
                              emulate.ranks(layout))
    got = emulate.forces(SimConfig(**kw), _port_state(jst), layout)
    _close(got, (xf, yf), TOL_DENSE, str(layout))


def _pallas_geometry(monkeypatch, calls):
    """Route the ranks' kernel calls to K1's plain version at the JAX
    geometry, recording each call's shapes and offsets."""
    def at_jax_geometry(cfg, xi, yi, mi, ri, xj, yj, mj, rj, *, row_g0,
                        col_g0, biased, accum):
        m, k = xi.shape[0], xj.shape[0]
        assert max(m, k) <= cuda_step.STREAMED_ABOVE
        calls.append((m, k, row_g0, col_g0))
        return cuda_step.block_forces_reference(
            cfg, xi, yi, mi, ri, xj, yj, mj, rj, row_g0=row_g0,
            col_g0=col_g0, biased=biased, accum=accum,
            row_block=min(1024, -(-m // 128) * 128),
            tile=min(1024, -(-k // 128) * 128))

    for module in (sharded_step, grid2d):
        monkeypatch.setattr(module, "block_forces_auto", at_jax_geometry)


@pytest.mark.parametrize("layout", [("allgather", 2), ("allgather", 8),
                                    ("ring", 2), ("ring", 4),
                                    ("grid2d", 2, 2), ("grid2d", 2, 4)],
                         ids=lambda l: "x".join(map(str, l[1:])) + "-"
                         + l[0])
def test_rank_kernel_path_matches_jax_pallas(layout, monkeypatch):
    """The kernel path (padded to ranks x 128, as both CLIs pad under
    --pallas) against the JAX sharded run through the Pallas kernel in
    interpret mode, fp64; the ranks' calls carry the JAX offsets."""
    p = emulate.ranks(layout)
    kw = dict(force_mode="fast", dtype="float64")
    fields = _initial(200, kw)
    jcfg = JaxConfig(kernel="pallas", pallas_interpret=True, **kw)
    jst, xf, yf = _jax_forces(jcfg, fields, layout, p * 128)
    calls = []
    _pallas_geometry(monkeypatch, calls)
    got = emulate.forces(SimConfig(kernel="cuda", **kw), _port_state(jst),
                         layout)
    _close(got, (xf, yf), TOL_KERNEL, str(layout))
    shard = jst.x.shape[0] // p
    if layout[0] == "allgather":
        want = [(shard, p * shard, k * shard, 0) for k in range(p)]
    elif layout[0] == "ring":
        want = [(shard, shard, k * shard, ((k + s) % p) * shard)
                for k in range(p) for s in range(p)]
    else:
        _, pr, pc = layout
        want = [(shard * pc, shard, r * shard * pc, (rr * pc + c) * shard)
                for r in range(pr) for c in range(pc) for rr in range(pr)]
    assert calls == want


def test_emulated_ranks_catch_a_wrong_row_offset(monkeypatch):
    """The comparison can fail: rank 1's row_g0 one tile (128) low flips
    the coincident kick of a pair across the rank boundary."""
    kw = dict(force_mode="fast", dtype="float64", kernel="cuda")
    cfg = SimConfig(**kw)
    f = _initial(256, kw)
    f["x"][127], f["y"][127] = f["x"][128], f["y"][128]
    st = state_from_numpy(f, dtype=torch.float64)
    good = emulate.forces(cfg, st, ("allgather", 2))
    whole = cuda_step.block_forces(cfg, *(st.x, st.y, st.mass, st.radius),
                                   *(st.x, st.y, st.mass, st.radius),
                                   biased=True)
    _close(good, whole, TOL_KERNEL)
    plain = cuda_step.block_forces_auto

    def shifted(cfg, *args, row_g0, **kw):
        return plain(cfg, *args, row_g0=row_g0 - (128 if row_g0 else 0),
                     **kw)

    monkeypatch.setattr(sharded_step, "block_forces_auto", shifted)
    bad = emulate.forces(cfg, st, ("allgather", 2))
    err = float((bad[0] - whole[0]).abs().max())
    assert err > 1e3 * TOL_KERNEL * float(whole[0].abs().max())


# ---------------------------------------------------------------------------
# the parallel CSV row, mesh messages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precise", [False, True])
def test_xps_csv_par_byte_equal(precise):
    for args in [(4, 1, 4, 97, 1.23456, 0.0123456, 12.3456),
                 (8, 2, 4, 65536, 0.0004, 0.0, 1e6),
                 (2, 1, 2, 10, 0.0, 0.5, float("nan"))]:
        assert toutput.xps_csv_par(*args, precise=precise) == \
            joutput.xps_csv_par(*args, precise=precise)


def test_mesh_messages_are_the_jax_package_s():
    with pytest.raises(ValueError, match="requested a 9-device mesh but "
                       "only 8 device"):
        check_mesh_fits((9,), 8, "cpu")
    with pytest.raises(ValueError) as e:
        check_mesh_fits((3, 4), 8, "cpu")
    with pytest.raises(ValueError) as je:
        jmesh2d(3, 4)
    assert str(e.value) == str(je.value)
    check_mesh_fits((2, 4), 8, "cpu")


# ---------------------------------------------------------------------------
# the directory checkpoint, in one process
# ---------------------------------------------------------------------------

def _state(n=40, dtype=torch.float64):
    f = {k: np.random.RandomState(i).uniform(0, 9, n)
         for i, k in enumerate(State._fields)}
    return state_from_numpy(f, dtype=dtype)


def test_directory_checkpoint_round_trip(tmp_path):
    st = _state()
    path = str(tmp_path / "ck")
    ckpt.save_state_dcp(path, st, 17, n_real=33)
    meta = ckpt.dcp_metadata(path)
    assert ckpt.dcp_saved_length(path, meta) == 40
    back, step, n_real = ckpt.load_state_dcp(path, "cpu", torch.float64)
    assert (step, n_real) == (17, 33)
    for a, b in zip(back, st):
        assert a.dtype == torch.float64 and torch.equal(a, b)
    # Overwriting a checkpoint directory is allowed; a float32 run reads it
    # in its own dtype.
    ckpt.save_state_dcp(path, st, 18)
    back, step, n_real = ckpt.load_state_dcp(path, "cpu", torch.float32)
    assert (step, n_real) == (18, 40)
    assert torch.equal(back.x, st.x.float())


def test_directory_checkpoint_rejects_other_directories(tmp_path):
    with pytest.raises(ValueError, match="not a torch.distributed"):
        ckpt.dcp_metadata(str(tmp_path))


@pytest.mark.parametrize("kind", ["file", "dangling symlink",
                                  "symlink to a directory"])
def test_directory_checkpoint_target_guard(kind, tmp_path):
    """Decided (ROADMAP Q3): only a directory is overwritten.  A regular
    file is refused as in the JAX package; a dangling symlink is refused
    too (the JAX package's os.path.exists lets it through and Orbax
    replaces the link); a symlink to a directory writes into it."""
    path = str(tmp_path / "target")
    if kind == "file":
        with open(path, "w") as f:
            f.write("keep me")
    elif kind == "dangling symlink":
        os.symlink(str(tmp_path / "nowhere"), path)
    else:
        os.mkdir(str(tmp_path / "real"))
        os.symlink(str(tmp_path / "real"), path)
    if kind == "symlink to a directory":
        ckpt.save_state_dcp(path, _state(), 1)
        assert ckpt.dcp_saved_length(str(tmp_path / "real")) == 40
        return
    with pytest.raises(ValueError, match="refusing to replace existing "
                       "non-directory file"):
        ckpt.save_state_dcp(path, _state(), 1)
    assert os.path.lexists(path) and not os.path.isdir(path)
    if kind == "file":
        with open(path) as f:
            assert f.read() == "keep me"
    assert not os.path.exists(str(tmp_path / "nowhere"))


# ---------------------------------------------------------------------------
# a process group of this process alone (gloo)
# ---------------------------------------------------------------------------

@pytest.fixture
def world_of_one(tmp_path):
    import torch.distributed as dist
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _world_runners(cfg, steps):
    from parallel_nbody_tpu_torch.parallel.mesh import make_mesh
    return {"allgather": sharded_step.make_sharded_run(cfg, make_mesh(1),
                                                       steps, "allgather"),
            "ring": sharded_step.make_sharded_run(cfg, make_mesh(1), steps,
                                                  "ring"),
            "grid2d": grid2d.make_grid2d_run(cfg, grid2d.make_mesh2d(1, 1),
                                             steps)}


@pytest.mark.parametrize("program", ["allgather", "ring", "grid2d"])
def test_world_of_one_is_engine_run(program, world_of_one):
    """World size 1 (chip_smoke's phase A on gloo): the kernel path is
    bit-equal to engine.run — the same call, the tagged flag equal to
    any_coincident's, no hop, a one-rank all-reduce."""
    from parallel_nbody_tpu_torch.models.engine import run
    from parallel_nbody_tpu_torch.state import init_state
    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
    st = init_state(512, cfg)
    want = run(cfg, st, 4)
    got = _world_runners(cfg, 4)[program](st)
    for f, g, w in zip(State._fields, got, want):
        assert torch.equal(g, w), f


def test_comm_timing_and_trace_share(world_of_one, tmp_path):
    """measure_comm_fraction times each program's collectives alone;
    trace_comm_share reads the gathers of a traced all-gather run as
    collective time (gloo operations), and finds none in a ring of one
    rank, which makes no hop."""
    from parallel_nbody_tpu_torch.parallel.mesh import make_mesh
    from parallel_nbody_tpu_torch.state import init_state
    from parallel_nbody_tpu_torch.utils.timing import (measure_comm_fraction,
                                                       trace,
                                                       trace_comm_share)
    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
    st = init_state(256, cfg)
    for comm, mesh in (("allgather", make_mesh(1)), ("ring", make_mesh(1)),
                       ("grid2d", grid2d.make_mesh2d(1, 1))):
        t = measure_comm_fraction(cfg, mesh, st, comm, iters=3)
        assert 0 <= t < 1, comm
    runners = _world_runners(cfg, 2)

    def share(program):
        log_dir = str(tmp_path / program)
        with trace(log_dir):
            runners[program](st)
        return trace_comm_share(log_dir)

    gathered = share("allgather")
    assert gathered["collective_us"] > 0 and 0 < gathered["share"] < 1
    assert any("gloo" in k or "all_gather" in k or "allgather" in k
               for k in gathered["by_op"])
    alone = share("ring")
    assert alone["collective_us"] == 0 and alone["op_us"] > 0
