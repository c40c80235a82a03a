"""The port's host layer against the JAX package: config, glibc init, state
helpers, output contract, PPM header, argv parsing, and import hygiene.

Inputs are made with numpy from a seed and handed to both packages; every
comparison here is exact (bit-equal arrays, byte-equal text).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import parallel_nbody_tpu.cli as jcli
import parallel_nbody_tpu.config as jconfig
import parallel_nbody_tpu.state as jstate
import parallel_nbody_tpu.utils.glibc_rand as jglibc
import parallel_nbody_tpu.utils.output as joutput
import parallel_nbody_tpu.utils.ppm as jppm
import parallel_nbody_tpu_torch.cli as tcli
import parallel_nbody_tpu_torch.config as tconfig
import parallel_nbody_tpu_torch.state as tstate
import parallel_nbody_tpu_torch.utils.glibc_rand as tglibc
import parallel_nbody_tpu_torch.utils.output as toutput
import parallel_nbody_tpu_torch.utils.ppm as tppm
from parallel_nbody_tpu_torch.utils import native_bridge
from parallel_nbody_tpu_torch.utils.convert import (config_from_dict,
                                                    state_from_numpy)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# config and conversion
# ---------------------------------------------------------------------------

def test_constants_equal():
    for name in ("GRAVITY", "FRICTION", "MAXBODIES", "DELTA_T", "SEED"):
        assert getattr(tconfig, name) == getattr(jconfig, name)


@pytest.mark.parametrize("jkw, kernel", [
    (dict(), "dense"),
    (dict(kernel="pallas", force_mode="fast", dtype="float32"), "cuda"),
    (dict(kernel="xla", force_mode="fast", dtype="bfloat16", xdim=640,
          ydim=480), "dense"),
    (dict(accum="compensated"), "dense"),
    (dict(kernel="pallas", force_mode="fast", dtype="float32",
          accum="compensated"), "cuda"),
    (dict(kernel="pallas", force_mode="fast", dtype="bfloat16",
          accum="compensated"), "cuda"),
])
def test_config_from_dict(jkw, kernel):
    jcfg = jconfig.SimConfig(**jkw)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    assert cfg.kernel == kernel
    for f in ("xdim", "ydim", "gravity", "friction", "dt", "force_mode",
              "dtype", "accum"):
        assert getattr(cfg, f) == getattr(jcfg, f)


@pytest.mark.parametrize("kw, exc", [
    (dict(kernel="cuda", force_mode="trig"), ValueError),
    (dict(dtype="float16"), ValueError),
    (dict(dtype="int8"), ValueError),
    (dict(kernel="triton"), ValueError),
    (dict(accum="kahan"), ValueError),
    (dict(kernel="cuda", force_mode="fast", dtype="float16"), ValueError),
])
def test_config_validation(kw, exc):
    with pytest.raises(exc):
        tconfig.SimConfig(**kw)


@pytest.mark.parametrize("kw", [
    dict(accum="compensated"),
    dict(kernel="xla", force_mode="fast", accum="compensated"),
    dict(kernel="cuda", force_mode="fast", accum="compensated"),
    dict(kernel="cuda", force_mode="fast", dtype="bfloat16"),
    dict(kernel="pallas", force_mode="fast", dtype="bfloat16",
         accum="compensated"),
])
def test_config_accepts_what_jax_accepts(kw):
    """Every accum with every kernel, and bf16 storage with the CUDA
    kernels: the JAX SimConfig takes the same fields (its names for the
    kernels)."""
    jkw = dict(kw, kernel={"cuda": "pallas"}.get(kw.get("kernel"),
                                                 kw.get("kernel", "xla")))
    jconfig.SimConfig(**jkw)
    cfg = tconfig.SimConfig(**kw)
    assert cfg.accum == kw.get("accum", "plain")
    assert cfg.dtype == kw.get("dtype", "float64")


def test_state_from_numpy_round_trip():
    cfg = jconfig.SimConfig()
    jst = jstate.init_state(50, cfg)
    fields = {k: np.asarray(v) for k, v in jst._asdict().items()}
    st = state_from_numpy(fields, dtype=torch.float64)
    for f in tstate.State._fields:
        np.testing.assert_array_equal(_np(getattr(st, f)), fields[f])
    with pytest.raises(ValueError):
        state_from_numpy({"x": fields["x"]}, dtype=torch.float64)


# ---------------------------------------------------------------------------
# glibc init and state helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [27102015, 0, 1, 2**31 + 5, 2**32 - 1])
def test_glibc_rand_stream_equal(seed):
    a, b = jglibc.GlibcRand(seed), tglibc.GlibcRand(seed)
    assert [a.rand() for _ in range(200)] == [b.rand() for _ in range(200)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n", [2, 128, 4096])
def test_init_state_bit_equal(n, dtype):
    jst = jstate.init_state(n, jconfig.SimConfig(dtype=dtype))
    st = tstate.init_state(n, tconfig.SimConfig(dtype=dtype))
    for f in tstate.State._fields:
        want = np.asarray(getattr(jst, f))
        got = _np(getattr(st, f))
        assert got.dtype == want.dtype, f
        assert got.tobytes() == want.tobytes(), f


def test_native_init_matches_python_loop(monkeypatch):
    """N >= 4096 takes the native init; the numpy loop gives the same
    bits."""
    assert native_bridge.available()
    native = tglibc.nbody_init_arrays(4096, 1024, 768)
    monkeypatch.setattr(native_bridge, "available", lambda: False)
    python = tglibc.nbody_init_arrays(4096, 1024, 768)
    for a, b in zip(native, python):
        assert a.tobytes() == b.tobytes()


def test_init_state_overflow_is_loud():
    with pytest.raises(ValueError, match="overflows dtype"):
        tstate._checked_cast(np.array([1.0, 1e300]), torch.float32, "mass")


def test_pad_unpad_matches_jax():
    cfg = jconfig.SimConfig()
    jpad, jn = jstate.pad_state(jstate.init_state(100, cfg), 48)
    pad, n = tstate.pad_state(tstate.init_state(100, tconfig.SimConfig()), 48)
    assert (n, pad.n) == (jn, jpad.n) == (100, 144)
    for f in tstate.State._fields:
        np.testing.assert_array_equal(_np(getattr(pad, f)),
                                      np.asarray(getattr(jpad, f)))
    back = tstate.unpad_state(pad, n)
    assert back.n == 100
    same, n2 = tstate.pad_state(back, 50)
    assert same is back and n2 == 100


def test_random_state_law():
    cfg = tconfig.SimConfig(dtype="float32")
    gen = torch.Generator().manual_seed(0)
    st = tstate.random_state(1000, cfg, gen)
    assert all(t.shape == (1000,) and t.dtype == torch.float32 for t in st)
    assert float(st.x.min()) >= 0 and float(st.x.max()) < cfg.xdim
    assert float(st.y.min()) >= 0 and float(st.y.max()) < cfg.ydim
    assert float(st.xv.abs().max()) <= 5.0
    # The radius/mass law is the JAX package's (it does not use the key).
    import jax
    jst = jstate.random_state(1000, jconfig.SimConfig(dtype="float32"),
                              jax.random.PRNGKey(0))
    np.testing.assert_allclose(_np(st.radius), np.asarray(jst.radius),
                               rtol=1e-6)
    np.testing.assert_allclose(_np(st.mass), np.asarray(jst.mass), rtol=1e-6)
    again = tstate.random_state(1000, cfg, torch.Generator().manual_seed(0))
    assert torch.equal(again.x, st.x)


# ---------------------------------------------------------------------------
# output contract
# ---------------------------------------------------------------------------

def _random_fields(seed, n=300):
    rng = np.random.RandomState(seed)
    scale = np.array([1e3, 1e3, 1e6, 1e6, 10.0, 10.0])
    f = [rng.uniform(-1, 1, n) * s for s in scale]
    f[2][:5] = [0.0005, -0.0005, 0.0015, -0.0, 123456789.0]
    return f


@pytest.mark.parametrize("native", [True, False])
def test_format_state_byte_equal(native, monkeypatch):
    x, y, xf, yf, xv, yv = _random_fields(3)
    z = np.zeros_like(x)
    jst = jstate.State(x, y, xv, yv, xf, yf, z, z)
    want = joutput.format_state(jst)
    if not native:
        monkeypatch.setattr(native_bridge, "format_state_native",
                            lambda *a: None)
    tst = tstate.State(*(torch.from_numpy(a)
                         for a in (x, y, xv, yv, xf, yf, z, z)))
    assert toutput.format_state(tst) == want


def test_counts_and_csv_equal():
    for n, steps in [(2, 1), (128, 1000), (65536, 100), (10**7, 3)]:
        assert toutput.nr_flops(n, steps) == joutput.nr_flops(n, steps)
        assert (toutput.pair_interactions(n, steps)
                == joutput.pair_interactions(n, steps))
    for n, rtime, gflops in [(128, 1.23456, 0.5), (65536, 0.0004, 1e6)]:
        assert (toutput.xps_csv_seq(n, rtime, gflops)
                == joutput.xps_csv_seq(n, rtime, gflops))


def test_ppm_header_equal(tmp_path):
    p = str(tmp_path / "a.ppm")
    with open(p, "wb") as f:
        f.write(b"P6\n# comment line\n640 # inline\n480\n255\n"
                + bytes(640 * 480 * 3))
    assert dataclasses.asdict(tppm.read_header(p)) == \
        dataclasses.asdict(jppm.read_header(p))
    q = str(tmp_path / "b.ppm")
    made = tppm.create(q, 32, 16)
    assert made.data_offset == jppm.read_header(q).data_offset
    bad = str(tmp_path / "bad.ppm")
    with open(bad, "wb") as f:
        f.write(b"P3\n1 1\n255\n")
    with pytest.raises(tppm.PPMError):
        tppm.read_header(bad)


# ---------------------------------------------------------------------------
# argv contract
# ---------------------------------------------------------------------------

ARGVS = [
    ["abc", "0", "a.ppm", "10"],
    ["1", "0", "a.ppm", "10"],
    ["20000", "0", "a.ppm", "10"],
    ["20000", "0", "a.ppm", "10", "--no-clamp"],
    ["12x", " 3", "a.ppm", "3.9", "--run-xps"],
    ["-5", "+2", "a.ppm", "-"],
    ["64", "0", "a.ppm", "5", "--pallas", "--dtype=float32", "--openmp"],
    ["64", "0", "a.ppm", "5", "--fast", "--chunk-steps=4", "--xps-precise"],
    ["64", "0", "a.ppm", "5", "--devices=4", "--comm=ring",
     "--mesh2d=2X4", "--accum=compensated", "--trace=t", "--check-nans",
     "--checkpoint=c.npz", "--resume=r", "--measure-comm"],
    ["64", "0", "a.ppm"],
    ["64", "0", "a.ppm", "5", "--bogus"],
    ["64", "0", "a.ppm", "5", "--devices=0"],
    ["64", "0", "a.ppm", "5", "--comm=tree"],
    ["64", "0", "a.ppm", "5", "--mesh2d=2"],
    ["64", "0", "a.ppm", "5", "--dtype=float16"],
    ["64", "0", "a.ppm", "5", "--dtype=int8"],
    ["64", "0", "a.ppm", "5", "--accum=fancy"],
    ["64", "0", "a.ppm", "5", "--chunk-steps=0"],
    ["64", "0", "a.ppm", "5", "--trace="],
]


def _parse(parse, argv, capsys):
    try:
        out = parse(["nbody"] + argv)
    except SystemExit as e:
        out = ("exit", e.code)
    return out, capsys.readouterr().err


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a))
def test_parse_args_equal(argv, capsys):
    assert _parse(tcli.parse_args, argv, capsys) == \
        _parse(jcli.parse_args, argv, capsys)


def test_atoi_equal():
    for s in ("123", "  -42xyz", "+7", "abc", "", "-", "3.9", "\t8"):
        assert tcli._atoi(s) == jcli._atoi(s)


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------

def test_port_never_imports_jax():
    """Every module of the port, found by walking the package (so new
    modules are covered), and chip_smoke.py import without loading JAX,
    the JAX package or the JAX package's benchmarks/ scripts."""
    code = ("import importlib, os, pkgutil, sys\n"
            "import parallel_nbody_tpu_torch as pkg\n"
            "import chip_smoke\n"
            "names = [m.name for m in pkgutil.walk_packages(\n"
            "    pkg.__path__, pkg.__name__ + '.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "bench = os.path.join(%r, 'benchmarks') + os.sep\n"
            "bad = sorted(m for m, mod in list(sys.modules.items())\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib',\n"
            "                                    'parallel_nbody_tpu',\n"
            "                                    'benchmarks')\n"
            "             or (getattr(mod, '__file__', None) or '')\n"
            "             .startswith(bench))\n"
            "assert not bad, bad\n"
            "print('\\n'.join(names))\n" % REPO)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    walked = set(r.stdout.split())
    for name in ("cli", "__main__", "models.engine", "ops.cuda_step",
                 "ops._build", "benchmarks.roofline_probe",
                 "benchmarks.bias_variants_probe", "utils.convert",
                 "parallel.mesh", "parallel.sharded_step", "parallel.grid2d",
                 "parallel.multihost", "parallel.emulate",
                 "parallel.dryrun"):
        assert "parallel_nbody_tpu_torch." + name in walked, name


def test_packaging_ships_the_parallel_subpackage():
    """pyproject.toml's package patterns take in every subpackage of the
    port, ``parallel`` included."""
    import tomllib

    from setuptools import find_packages
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        include = tomllib.load(f)["tool"]["setuptools"]["packages"]["find"][
            "include"]
    found = set(find_packages(REPO, include=include))
    assert {"parallel_nbody_tpu_torch.parallel",
            "parallel_nbody_tpu_torch.ops",
            "parallel_nbody_tpu_torch.utils"} <= found


def test_package_data_ships_every_kernel_source():
    """Every file under csrc/ matches a package-data glob of
    pyproject.toml, so an installed package can build its kernels."""
    import fnmatch
    import tomllib
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    globs = data["parallel_nbody_tpu_torch"]
    csrc = os.path.join(REPO, "parallel_nbody_tpu_torch", "csrc")
    files = sorted(os.listdir(csrc))
    assert {"pairs.cuh", "forces.cu", "roofline_probe.cu"} <= set(files)
    for name in files:
        assert any(fnmatch.fnmatch("csrc/" + name, g) for g in globs), name
