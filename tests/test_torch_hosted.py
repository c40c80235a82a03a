"""The port's huge-N path against the JAX package's, on the CPU.

``models.engine.make_hosted_row_step`` (the force pass through K2 in row
launches, ``ops.cuda_step.streamed_forces``), ``ops.render.
render_frame_hosted`` (frames in body chunks), the CLI's
``NBODY_HUGE_THRESHOLD`` branch (no step discarded to warm up or to probe
the frame cadence) with K2's row launches under it, and the ``huge_n``
tool's argv.  Inputs come from the glibc init (``init_state``) or from
numpy with a seed.  On the CPU every K2 launch is K2's plain version
(``block_forces_streamed_reference``).

Tolerances: the row-chunked step against JAX ``make_hosted_row_step`` in
interpret mode within the JAX test's ``rtol=1e-5, atol=1e-3``
(tests/test_pallas_kernel.py::test_hosted_row_step_matches_fused_step: the
port sums 128-column tiles, Pallas 1024-column ones), but for one named row
whose terms cancel, held to 1e-5 of max|F|; the port's CLI against the JAX
CLI within ``rtol=1e-4, atol=2e-3`` (tests/test_cli.py::
test_huge_path_via_cli_matches_fused).  Everything else is exact: a row's
plain K2 sum does not depend on how many rows share the call, and the bias
segments follow 128-row blocks, which a chunk that starts at a multiple of
128 keeps; frames are integer minima of the same per-pixel tests.
"""

import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_nbody_tpu.cli as jcli
from parallel_nbody_tpu.config import SimConfig as JaxConfig
from parallel_nbody_tpu.models import engine as jengine
from parallel_nbody_tpu.ops import render as jrender
from parallel_nbody_tpu.state import init_state as jax_init_state
from parallel_nbody_tpu_torch import cli
from parallel_nbody_tpu_torch.benchmarks import huge_n
from parallel_nbody_tpu_torch.config import SimConfig
from parallel_nbody_tpu_torch.models import engine
from parallel_nbody_tpu_torch.ops import cuda_step, render
from parallel_nbody_tpu_torch.state import State, init_state
from parallel_nbody_tpu_torch.utils import ppm

torch.set_num_threads(1)

CFG = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
FIELDS = ("x", "y", "xv", "yv", "xf", "yf")
# The one row of the glibc init at N=515 whose force, two steps on, the
# port and Pallas round apart by more than rtol=1e-5, atol=1e-3.
CANCELLING_ROW = 345


def _uniform_state(n: int, seed: int) -> State:
    """Seeded non-integer positions (no two coincide), the reference's
    radius and mass laws' ranges, zero velocities."""
    rng = np.random.RandomState(seed)
    radius = rng.uniform(1.0, 6.0, n)
    cols = [rng.uniform(0, 1024, n), rng.uniform(0, 768, n), np.zeros(n),
            np.zeros(n), np.zeros(n), np.zeros(n), radius ** 3, radius]
    return State(*(torch.tensor(c, dtype=torch.float32) for c in cols))


def _one_call_step(cfg, st):
    """One step with the force pass as ONE call of K2 over all rows."""
    cols = (st.x, st.y, st.mass, st.radius)
    xf, yf = cuda_step.block_forces_streamed(
        cfg, *cols, *cols, biased=cuda_step.any_coincident(st.x, st.y,
                                                           st.mass),
        accum=cfg.accum)
    return engine._integrate(cfg, st, xf, yf)


# ---------------------------------------------------------------------------
# make_hosted_row_step
# ---------------------------------------------------------------------------

def test_hosted_row_step_matches_jax_hosted_row_step():
    """N=515 in row chunks of 128 (a tail chunk of 3), two steps, against
    JAX ``make_hosted_row_step`` with the Pallas kernel in interpret mode
    from the same glibc init."""
    n = 515
    jcfg = JaxConfig(force_mode="fast", dtype="float32", kernel="pallas",
                     pallas_interpret=True)
    jstep, jwarm = jengine.make_hosted_row_step(jcfg, n, row_chunk=128)
    jwarm()
    want = jstep(jstep(jax_init_state(n, jcfg)))
    step_fn, _ = engine.make_hosted_row_step(CFG, n, row_chunk=128)
    got = step_fn(step_fn(init_state(n, CFG)))
    for f in FIELDS:
        w = np.asarray(getattr(want, f), np.float64)
        g = getattr(got, f).double().numpy()
        # The two sum each row in other tiles.  Row CANCELLING_ROW's x
        # terms of ~1e7 cancel to ~1e2, and there the orders differ by
        # ~5e-9 of max|F|, past the per-element bound: that row alone is
        # held to the port-against-Pallas bound of
        # tests/test_torch_streamed.py, 1e-5 of max|F|.
        wide = np.abs(g - w) > 1e-3 + 1e-5 * np.abs(w)
        assert set(np.nonzero(wide)[0]) <= (
            {CANCELLING_ROW} if f == "xf" else set()), f
        keep = np.arange(n) != CANCELLING_ROW
        np.testing.assert_allclose(g[keep], w[keep], rtol=1e-5, atol=1e-3,
                                   err_msg="field " + f)
        assert abs(g[CANCELLING_ROW] - w[CANCELLING_ROW]) <= \
            1e-5 * np.abs(w).max(), f


@pytest.mark.parametrize("coincident", [False, True],
                         ids=["unbiased", "biased"])
@pytest.mark.parametrize("row_chunk", [128, 256, 515])
def test_hosted_row_step_bit_equal_to_one_call(row_chunk, coincident):
    """The row-chunked step is the one-call K2 step bit for bit, two steps
    deep: from the glibc init, whose integer positions hold coincident
    bodies at N=515 (the biased flag set, kicks across chunks), and from
    seeded non-integer positions (the flag clear)."""
    n = 515
    st = init_state(n, CFG) if coincident else _uniform_state(n, 5)
    assert bool(cuda_step.any_coincident(st.x, st.y, st.mass)) == coincident
    step_fn, _ = engine.make_hosted_row_step(CFG, n, row_chunk=row_chunk)
    got = step_fn(step_fn(st))
    want = _one_call_step(CFG, _one_call_step(CFG, st))
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_hosted_row_step_fences_each_chunk():
    """``fence`` sees each chunk's xf, the tail chunk shorter."""
    seen = []
    step_fn, _ = engine.make_hosted_row_step(CFG, 300, row_chunk=128)
    step_fn(init_state(300, CFG), fence=lambda a: seen.append(a.shape[0]))
    assert seen == [128, 128, 44]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_streamed_rows_bound_k2s_workspace(dtype):
    """cuda_forces' K2 launches: the most rows, in whole tiles, whose
    (bands, 2, rows) workspace in the compute dtype fits
    K2_WORKSPACE_BYTES; one launch over all rows at N=2**21."""
    budget = cuda_step.K2_WORKSPACE_BYTES
    item = 8 if dtype == torch.float64 else 4
    for n in (131073, 1 << 21, 3_000_000, 10_000_000, 27_000_000):
        rows = cuda_step.streamed_rows(n, dtype)
        per_row = -(-n // cuda_step.STREAM_BAND) * 2 * item
        assert rows % cuda_step.TILE == 0
        assert rows * per_row <= budget < (rows + cuda_step.TILE) * per_row
    assert cuda_step.streamed_rows(1 << 21, dtype) >= 1 << 21
    assert cuda_step.streamed_rows(27_000_000, dtype) < 27_000_000


# ---------------------------------------------------------------------------
# render_frame_hosted
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_render_frame_hosted_byte_equal_to_jax_and_render_frame(dtype):
    """xdim=128, ydim=96, N=300 with n_real=280, body chunks of 77 (the
    JAX test's case, tests/test_render.py)."""
    kw = dict(xdim=128, ydim=96, force_mode="trig", dtype=dtype)
    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    st = jax_init_state(300, jcfg)
    host = [np.asarray(a) for a in (st.x, st.y, st.radius)]
    assert host[0].dtype == np.dtype(dtype)
    want = jrender.render_frame_hosted(
        jcfg, *(jnp.asarray(a) for a in host), 280, body_chunk=77)
    tensors = [torch.from_numpy(a.copy()) for a in host]
    got = render.render_frame_hosted(cfg, *tensors, 280, body_chunk=77)
    whole = render.render_frame(cfg, *tensors, 280).numpy()
    assert isinstance(got, np.ndarray) and got.shape == (96, 128, 3)
    assert got.tobytes() == np.asarray(want).tobytes()
    assert got.tobytes() == whole.tobytes()
    assert got.any() and (got.reshape(-1, 3) == 0).all(axis=1).any()


def test_render_frame_hosted_first_hit_across_chunks():
    """Overlapping bodies in different chunks: the lower index wins, and a
    padding body (index >= n_real) never shows."""
    cfg = SimConfig(xdim=32, ydim=24)
    x = torch.tensor([10.0, 10.5, 11.0, 20.0], dtype=torch.float64)
    y = torch.tensor([10.0, 10.0, 10.5, 12.0], dtype=torch.float64)
    r = torch.tensor([2.0, 5.0, 3.0, 9.0], dtype=torch.float64)
    seen = []
    got = render.render_frame_hosted(cfg, x, y, r, 3, body_chunk=1,
                                     fence=lambda s: seen.append(s.shape))
    assert seen == [(24, 32)] * 4
    assert got.tobytes() == render.render_frame(cfg, x, y, r,
                                                3).numpy().tobytes()
    tint = render.tint_rgb(torch.tensor([0]), 3)[0].numpy()
    assert (got[10, 10] == tint).all()


# ---------------------------------------------------------------------------
# the CLI's huge branch
# ---------------------------------------------------------------------------

HUGE_ENV = {"NBODY_HUGE_THRESHOLD": "100"}
HUGE_ARGV = ["300", "1", None, "2", "--pallas", "--dtype=float32"]


@pytest.fixture
def small_arena(tmp_path):
    p = str(tmp_path / "small.ppm")
    ppm.create(p, 128, 96)
    return p


def _cli_run(main, argv, capsys, monkeypatch, env):
    monkeypatch.setenv("NBODY_PLATFORM", "cpu")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    capsys.readouterr()
    rc = main(["nbody"] + argv)
    out = capsys.readouterr()
    assert rc == 0, out.err[-3000:]
    return out.out, out.err


def _frames(path):
    """(nonzero, tints, md5) of each line of a frame log."""
    with open(path) as f:
        return [re.fullmatch(r"frame \d+\.\d{3} (nonzero=\d+ tints=\d+ "
                             r"md5=[0-9a-f]{32})", line).group(1)
                for line in f.read().splitlines()]


def _port_huge(argv, capsys, monkeypatch, tmp_path, k2_rows=None,
               label="port"):
    """(stdout, stderr, frames) of the port's CLI in its huge branch.  With
    ``k2_rows`` the force pass goes through K2 at this N (STREAMED_ABOVE
    lowered), in launches of ``k2_rows`` rows (K2_WORKSPACE_BYTES set to
    hold that many; ``"all"``: the default, one launch); None leaves it to
    engine.step (K1 at this N)."""
    n = int(argv[0])
    rows = []
    real = cuda_step.block_forces_streamed

    def spy(cfg, xi, *a, **kw):
        rows.append(xi.shape[0])
        return real(cfg, xi, *a, **kw)

    monkeypatch.setattr(cuda_step, "block_forces_streamed", spy)
    if k2_rows is not None:
        monkeypatch.setattr(cuda_step, "STREAMED_ABOVE", 0)
    if k2_rows not in (None, "all"):
        bands = -(-n // cuda_step.band_width(n, cuda_step.STREAM_BAND))
        monkeypatch.setattr(cuda_step, "K2_WORKSPACE_BYTES",
                            k2_rows * bands * 2 * 4)
    log = str(tmp_path / (label + ".log"))
    out, err = _cli_run(cli.main, argv, capsys, monkeypatch,
                        dict(HUGE_ENV, NBODY_FRAME_LOG=log))
    monkeypatch.undo()
    steps = int(argv[3])
    want = ([] if k2_rows is None else [n] if k2_rows == "all" else
            [min(k2_rows, n - r0) for r0 in range(0, n, k2_rows)]) * steps
    assert rows == want
    return out, err, _frames(log)


def _table(text):
    return np.array([[float(v) for v in line.split()]
                     for line in text.splitlines()])


@pytest.mark.parametrize("row_chunk", [None, 128])
def test_cli_huge_branch_matches_jax_cli(row_chunk, small_arena, capsys,
                                         monkeypatch, tmp_path):
    """``NBODY_HUGE_THRESHOLD=100`` at N=300 on both CLIs (the JAX CLI with
    --devices=1, its step K2 in host row chunks): the state within the JAX
    test's tolerance, and the first frame's pixel count, tint count and md5
    equal.  The port's force pass is engine.step's own (K1 at this N), or
    (128) K2 in launches of 128 rows."""
    argv = list(HUGE_ARGV)
    argv[2] = small_arena
    got, _, got_frames = _port_huge(argv, capsys, monkeypatch, tmp_path,
                                    row_chunk)
    jlog = str(tmp_path / "jax.log")
    want, _ = _cli_run(jcli.main, argv + ["--devices=1"], capsys,
                       monkeypatch, dict(HUGE_ENV, NBODY_FRAME_LOG=jlog))
    assert len(got.splitlines()) == 300
    np.testing.assert_allclose(_table(got), _table(want), rtol=1e-4,
                               atol=2e-3)
    want_frames = _frames(jlog)
    assert got_frames and want_frames
    assert got_frames[0] == want_frames[0]


def test_cli_huge_branch_byte_equal_across_row_chunks(small_arena, capsys,
                                                      monkeypatch, tmp_path):
    """K2 in launches of 128 rows (three a step) prints what one launch
    over all rows prints, and draws the same frames."""
    argv = list(HUGE_ARGV)
    argv[2] = small_arena
    out128, _, frames128 = _port_huge(argv, capsys, monkeypatch, tmp_path,
                                      128, "c128")
    out_n, _, frames_n = _port_huge(argv, capsys, monkeypatch, tmp_path,
                                    "all", "cn")
    assert out128 == out_n
    assert frames128 and frames128[0] == frames_n[0]


def test_cli_huge_branch_runs_no_probe_step(small_arena, capsys,
                                            monkeypatch):
    """40 steps with frames: the frame-cadence probe costs one force pass
    more below the threshold, none above it, and the output is the
    same."""
    argv = ["300", "1", small_arena, "40", "--pallas", "--dtype=float32"]
    passes = []
    real = engine.cuda_forces

    def spy(*a, **kw):
        passes.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(engine, "cuda_forces", spy)
    outs = []
    for env in ({}, HUGE_ENV):
        passes.clear()
        out, _ = _cli_run(cli.main, argv, capsys, monkeypatch, env)
        outs.append((out, len(passes)))
    assert outs[0][0] == outs[1][0]
    assert [p for _, p in outs] == [41, 40]


def test_cli_huge_branch_check_nans(small_arena, capsys, monkeypatch,
                                    tmp_path):
    """--check-nans in the huge branch checks every step and validates the
    end state; the printed state is that of the run without it."""
    argv = list(HUGE_ARGV)
    argv[1:3] = ["0", small_arena]
    plain, _ = _cli_run(cli.main, argv, capsys, monkeypatch, HUGE_ENV)
    checks = []
    real = engine.check_finite
    monkeypatch.setattr(engine, "check_finite",
                        lambda st, i: checks.append(i) or real(st, i))
    out, err = _cli_run(cli.main, argv + ["--check-nans"], capsys,
                        monkeypatch, HUGE_ENV)
    assert out == plain
    assert checks == [1, 2]
    assert "State validation ok" in err


# ---------------------------------------------------------------------------
# huge_n
# ---------------------------------------------------------------------------

def test_huge_n_takes_the_jax_tools_argv(tmp_path):
    """``huge_n N row_chunk out.ppm``: 4096 bodies in 4 chunks of 1024; the
    frame lands at out.ppm and the record names the chunks."""
    out_ppm = tmp_path / "frame.ppm"
    rec_path = tmp_path / "rec.json"
    assert huge_n.main(["huge_n", "4096", "1024", str(out_ppm),
                        "--device=cpu", "--out=%s" % rec_path]) == 0
    rec = json.loads(rec_path.read_text())
    assert rec["row_chunk"] == 1024 and rec["chunks"] == 4
    assert rec["n"] == 4096 and rec["frame"] == str(out_ppm)
    assert rec["step_peak_bytes"] is None  # not measured on the CPU
    assert not (tmp_path / "1024").exists()
    pixels = ppm.read_pixels(ppm.read_header(str(out_ppm)))
    assert pixels.any() and int(pixels.any(axis=2).sum()) == \
        rec["lit_pixels"]


def test_huge_n_refuses_a_row_chunk_below_one(tmp_path, capsys):
    assert huge_n.main(["huge_n", "64", "0", str(tmp_path / "f.ppm"),
                        "--device=cpu"]) == 1
    assert "row_chunk must be >= 1" in capsys.readouterr().err


def test_huge_n_step_is_the_one_call_step(tmp_path):
    """The tool's chunked step is the one-call K2 step bit for bit, with
    a tail chunk (4096 = 3 x 1280 + 256)."""
    cpu = torch.device("cpu")
    _, got = huge_n.huge_step(cpu, 4096, str(tmp_path / "f.ppm"), log=lambda s: None,
                              row_chunk=1280)
    cfg = huge_n.huge_cfg()
    from parallel_nbody_tpu_torch.state import random_state
    st = random_state(4096, cfg, torch.Generator().manual_seed(huge_n.SEED))
    want = _one_call_step(cfg, st)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f

