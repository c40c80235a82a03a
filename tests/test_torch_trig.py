"""The parity pass on the CPU: its plain version
(``ops.cuda_step.trig_forces_reference``, which ``trig_forces`` runs on CPU
tensors) against the dense trig path and the benchmark's plain reference
(``nbody_bench/reference/nbody_seq_parity.py``), ``engine.run`` and the
CLI's ``--pallas --trig`` against the reference binary's bytes and the JAX
package's dense trig step, the spelling's refusals, and the build and census
of csrc/forces_trig.cu.

Tolerances and why:
  - against ``compute_forces_dense`` (trig): none, bit for bit, one CPU
    thread (set below).  Both add each body's terms in ascending partner
    order from +0 and evaluate each pair from the same arguments with the
    same torch ops; every pair's atan2 takes ATen's vectorised loop on both
    sides (``cuda_step._atan2_vectorised``; the dense path's scalar tail
    lies in its last row, which holds no pair, from 16 bodies on).
  - against the plain reference, forces and step: 1e-13 of the sum of the
    terms' magnitudes (``abs_force``) and the check's own scales
    (``nbody_bench.check.step_gaps``).  The reference's torch.atan2 calls
    leave each call's last elements to ATen's scalar loop, whose glibc
    atan2 may round a term one ulp from the vectorised one; from there the
    two sums' later roundings may part, at most one half-ulp of a partial
    sum (itself at most ``abs_force``) per add: 1024 * 2**-53 = 1.1e-13.
    The velocities also differ where the port multiplies by 1/m (the JAX
    package's integration) and the reference divides by m
    (nbody-seq.c:114-130): a rounding of the velocity's increment.
    Measured at these sizes: 0.
  - the CLI against the fixtures: none, stdout byte for byte.
  - against the JAX package's dense trig step: forces within 1e-14 of
    max|F| (torch's atan2/cos/sin differ from XLA's by at most 1 ulp,
    tests/test_torch_ops.py), the state within 1e-14 relative.
"""

import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_bench import check
from nbody_bench.reference import nbody_seq_parity
from parallel_nbody_tpu.config import SimConfig as JaxConfig
from parallel_nbody_tpu.models import engine as jengine
from parallel_nbody_tpu.state import State as JaxState
from parallel_nbody_tpu_torch import cli
from parallel_nbody_tpu_torch.benchmarks import sass_census
from parallel_nbody_tpu_torch.config import SimConfig
from parallel_nbody_tpu_torch.models import engine
from parallel_nbody_tpu_torch.ops import _build, cuda_step
from parallel_nbody_tpu_torch.ops.forces import compute_forces_dense
from parallel_nbody_tpu_torch.state import State, init_state
from parallel_nbody_tpu_torch.utils import ppm
from torch_cases import REPO, TRIG_LAWS, trig_bodies

torch.set_num_threads(1)

CFG = SimConfig(force_mode="trig", dtype="float64", kernel="cuda")
DENSE = CFG.replace(kernel="dense")
SIZES = (2, 64, 333, 1024)
REF_TOL = 1e-13
FIXTURES = os.path.join(REPO, "tests", "fixtures")
CSRC = os.path.join(REPO, "parallel_nbody_tpu_torch", "csrc")


def _bodies(n, law):
    return [torch.tensor(a, dtype=torch.float64) for a in trig_bodies(n, law)]


def _bits(t):
    return t.view(torch.int64)


def _assert_bit_equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w)), \
            "%d of %d differ" % (int((g != w).sum()), g.numel())


@pytest.mark.parametrize("law", TRIG_LAWS)
@pytest.mark.parametrize("n", SIZES)
def test_plain_version_bit_equal_to_dense(n, law):
    """Coincident pairs ("glibc"), bodies on the walls, and ("row") y terms
    of +0 and -0 whose sums are +0 on both sides."""
    b = _bodies(n, law)
    got = cuda_step.trig_forces(CFG, *b)
    _assert_bit_equal(got, compute_forces_dense(DENSE, *b))
    if law == "row":
        assert torch.equal(_bits(got[1]), _bits(torch.zeros(n,
                                                            dtype=torch.float64)))


@pytest.mark.parametrize("chunk_elems", [333, 333 * 50, 333 * 333 - 1])
def test_plain_version_chunks_are_bit_equal(chunk_elems, monkeypatch):
    """Column chunks of one column, of 50 and of all but a sliver: the sums
    are each body's terms in order, whatever the chunks."""
    b = _bodies(333, "glibc")
    want = compute_forces_dense(DENSE, *b)
    monkeypatch.setattr(cuda_step, "_TRIG_CHUNK_ELEMS", chunk_elems)
    _assert_bit_equal(cuda_step.trig_forces(CFG, *b), want)


def test_vectorised_atan2_is_position_free():
    """An element's atan2 depends on its arguments alone: the same values at
    other offsets, in calls of other lengths, give the same bits."""
    g = torch.Generator().manual_seed(3)
    a = torch.randn(50000, generator=g, dtype=torch.float64)
    b = torch.randn(50000, generator=g, dtype=torch.float64)
    whole = cuda_step._atan2_vectorised(a, b)
    for s0, s1 in ((0, 1), (7, 20), (16383, 16390), (49990, 50000)):
        assert torch.equal(cuda_step._atan2_vectorised(a[s0:s1], b[s0:s1]),
                           whole[s0:s1])
    two = cuda_step._atan2_vectorised(a.view(250, 200), b.view(250, 200))
    assert torch.equal(two.reshape(-1), whole)


def _cfg_dict(cfg):
    return dict(gravity=cfg.gravity, friction=cfg.friction, dt=cfg.dt,
                xdim=cfg.xdim, ydim=cfg.ydim, dtype=cfg.dtype,
                reference="nbody_seq_parity")


@pytest.mark.parametrize("law", TRIG_LAWS)
@pytest.mark.parametrize("n", SIZES[1:])
def test_plain_version_matches_parity_reference(n, law):
    """Forces and one step of ``engine.step`` on a moving state (20 steps
    from the bodies at rest) against the plain reference."""
    b = _bodies(n, law)
    z = torch.zeros(n, dtype=torch.float64)
    st = engine.run(CFG, State(b[0], b[1], z, z, z, z, b[2], b[3]), 20)
    fx, fy, abs_force = nbody_seq_parity.forces(st.x, st.y, st.mass,
                                                st.radius, CFG.gravity)
    for got, want in zip(cuda_step.trig_forces(CFG, st.x, st.y, st.mass,
                                               st.radius), (fx, fy)):
        assert float(((got - want).abs() / abs_force).max()) <= REF_TOL
    out = engine.step(CFG, st)
    prev = {k: getattr(st, k) for k in ("x", "y", "xv", "yv")}
    ref = check.reference_step(prev, st.mass, st.radius, _cfg_dict(CFG))
    gaps = check.step_gaps({k: getattr(out, k) for k in
                            ("x", "y", "xv", "yv", "xf", "yf")}, ref,
                           st.mass, _cfg_dict(CFG))
    assert max(gaps.values()) <= REF_TOL, gaps


def _main(argv, capsys, monkeypatch):
    monkeypatch.setenv("NBODY_PLATFORM", "cpu")
    rc = cli.main(["nbody"] + argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.fixture(scope="module")
def arena(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("arena") / "nbody.ppm")
    ppm.create(p, 1024, 768)
    return p


@pytest.mark.parametrize("n, steps, name", [
    (64, 500, "seq_64_500.out"),
    (256, 300, "seq_256_300.out"),
])
def test_cli_trig_spelling_prints_fixture(n, steps, name, arena, capsys,
                                          monkeypatch):
    """``--pallas --trig`` on the CPU (the parity pass's plain version, in
    float64 by default): the reference binary's bytes, and the same state
    as ``engine.run`` on the dense path."""
    rc, out, err = _main([str(n), "0", arena, str(steps), "--pallas",
                          "--trig"], capsys, monkeypatch)
    assert rc == 0, err
    with open(os.path.join(FIXTURES, name)) as f:
        assert out == f.read()


def test_trig_step_matches_jax_dense_step():
    """Three steps from the glibc init at N=256 (coincident pairs from the
    first step on): the parity pass's engine against the JAX package's
    dense trig engine."""
    n, steps = 256, 3
    cfg = CFG
    st = engine.run(cfg, init_state(n, cfg), steps)
    jst = init_state(n, DENSE)
    jstate = JaxState(*(jnp.asarray(t.numpy()) for t in jst))
    want = jengine.run(JaxConfig(force_mode="trig", dtype="float64"), jstate,
                       steps)
    for f in ("x", "y", "xv", "yv"):
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-14,
                                   atol=0, err_msg=f)
    for f in ("xf", "yf"):
        w = np.asarray(getattr(want, f))
        np.testing.assert_allclose(getattr(st, f).numpy(), w, rtol=0,
                                   atol=1e-14 * np.abs(w).max(), err_msg=f)


@pytest.mark.parametrize("argv, message", [
    (["--trig"], "--trig selects the parity pass of --pallas"),
    (["--pallas", "--trig", "--dtype=float32"], "float64 only"),
    (["--trig", "--pallas", "--dtype=bfloat16"], "float64 only"),
    (["--pallas", "--trig", "--devices=2"], "runs on one device"),
])
def test_cli_trig_refusals(argv, message, arena, capsys, monkeypatch):
    """The parser's refusals exit 1 (SystemExit), a mesh returns 1."""
    monkeypatch.setenv("NBODY_PLATFORM", "cpu")
    try:
        rc = cli.main(["nbody", "64", "0", arena, "5"] + argv)
    except SystemExit as e:
        rc = e.code
    assert rc == 1
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("kw", [
    dict(force_mode="trig", dtype="float64", kernel="cuda"),
    dict(force_mode="trig", dtype="float64", kernel="pallas",
         accum="compensated"),
])
def test_config_accepts_the_parity_pass(kw):
    cfg = SimConfig(**kw)
    assert cfg.kernel == "cuda" and cfg.force_mode == "trig"


def test_trig_forces_refuses_other_dtypes():
    b = [t.float() for t in _bodies(64, "uniform")]
    with pytest.raises(TypeError, match="float64 only"):
        cuda_step.trig_forces(CFG, *b)


def test_trig_source_builds_the_slots_and_its_own_library():
    """The kernel has one build, 4 threads a row, which its launcher
    launches, and its source belongs to the step library alone
    (``kernels``), where it compiles to an object of its own, so no flag or
    change of it reaches K1's, K2's or the symmetric pass's code."""
    with open(os.path.join(CSRC, "forces_trig.cu")) as f:
        src = f.read()
    code = re.sub(r"//.*", "", src)
    assert re.search(r"constexpr int kRowSlots = 4;", code)
    assert re.findall(r"trig_forces_kernel<(\w+)>", code) == ["kRowSlots"]
    owners = [name for name, (files, _, _) in _build.LIBRARIES.items()
              if "forces_trig.cu" in files]
    assert owners == ["kernels"]
    assert [name for name in _build.LIBRARIES["kernels"][2]
            if name.startswith("nbody_trig")] == ["nbody_trig_forces_f64"]


def test_trig_launcher_argtypes_match_the_source():
    """The ctypes signature of the parity pass's launcher is the C one:
    x, y, mass, radius, n, gravity, the two outputs and the stream."""
    with open(os.path.join(CSRC, "forces_trig.cu")) as f:
        src = f.read()
    params = re.search(r"int nbody_trig_forces_f64\(([^)]*)\)", src).group(1)
    types = [" ".join(p.split()[:-1]).replace("const ", "")
             for p in params.split(",")]
    want = {"double*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int64_t": ctypes.c_int64, "double": ctypes.c_double}
    assert [want[t] for t in types] == \
        _build.LIBRARIES["kernels"][2]["nbody_trig_forces_f64"]


_SASS = """
        Function : _ZN47_GLOBAL__N__0_14_forces_trig_cu_018trig_forces_kernelILi4EEEvPKdS2_S2_S2_ldPdS3_
        /*0000*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0010*/                   LDS.64 R4, [R2] ;
        /*0020*/                   DADD R6, R4, -R8 ;
        /*0030*/                   DFMA R6, R6, R6, R10 ;
        /*0040*/                   DMUL R6, R6, R12 ;
        /*0050*/                   SHFL.IDX PT, R14, R6, RZ, 0x1c1f ;
        /*0060*/                   IMAD R1, R1, 0x1, R3 ;
        /*0070*/               @P0 BRA 0x10 ;
        /*0080*/                   EXIT ;
"""


def test_census_reads_the_trig_loop():
    """One pass of the parity loop is one pair a thread; its issue bound is
    the larger of its instructions and twice its FP64 instructions."""
    rows = sass_census.census(_SASS)
    assert [r[0] for r in rows] == ["trig_forces_kernel<Li4>"]
    row = rows[0]
    assert row[3] == 1
    assert sass_census.loop_roles(rows) == {(row[0], row[1]): "trig"}
    assert sass_census.instr_per_pair(row) == 7
    assert sass_census.fp64_per_pair(row) == 3
    assert sass_census.issue_cycles_per_pair(row) == 7
    assert "FP64  3.000" in sass_census.format_row(row, "trig")
