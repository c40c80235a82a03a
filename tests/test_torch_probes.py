"""The probes P1 (``benchmarks.roofline_probe``) and P2
(``benchmarks.bias_variants_probe``) of the port: their plain PyTorch
versions, in the Pallas probes' summation order and in the CUDA kernels'
(column parts folded in rank order), against the JAX package's Pallas
probe kernels, run as Pallas runs on the CPU (``interpret=True``, with the
specs of ``benchmarks/roofline_probe.py:75`` and
``benchmarks/bias_variants_probe.py:113``), their entry points without a
card, and the SASS census of the pair loops on small listings.

Inputs are made with numpy from a seed and handed to both sides: N=512,
uniform in [1, 2) as the probes draw them, with independent rows and
columns; a fed-back second call whose xi and yi are the first call's
outputs; and a square input (columns equal to rows) in which bodies 7 and
300, and 10 and 11, share a position.  The probes' own data has no
coincident pair, and on it every bias variant equals ``r2`` to rounding, so
only the square input tells the variants apart.

Tolerance: 1e-6 * max|F| in fp32.  Both sides compute each pair term with
the same operations in the same order; they sum the terms of a tile in
another order (measured: at most 2.2e-7 * max|F| over all cases at N=512),
and the kernels' order adds the column parts in another grouping (at most
3.3e-7 * max|F| from the Pallas order at N=4096).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from parallel_nbody_tpu_torch.benchmarks import _probe
from parallel_nbody_tpu_torch.benchmarks import bias_variants_probe as tbias
from parallel_nbody_tpu_torch.benchmarks import roofline_probe as troof
from torch_cases import PROBE_COINCIDENT, probe_inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "parallel_nbody_tpu_torch", "csrc")
sys.path.insert(0, os.path.join(REPO, "benchmarks"))
import bias_variants_probe as jbias  # noqa: E402
import roofline_probe as jroof  # noqa: E402

torch.set_num_threads(1)

N = 512
TOL = 1e-6
PROBES = {"roofline_probe": (jroof, troof),
          "bias_variants_probe": (jbias, tbias)}
CASES = [(name, v) for name, (_, t) in PROBES.items() for v in t.VARIANTS]
COINCIDENT_ROWS = sorted(i for pair in PROBE_COINCIDENT for i in pair)


def _pallas(make_kernel, variant, arrays, tile_i, tile_j):
    """The JAX probe's kernel through pl.pallas_call in interpret mode."""
    n = arrays[0].shape[0]
    vec = pl.BlockSpec(memory_space=pltpu.VMEM)
    call = pl.pallas_call(
        make_kernel(variant, tile_i, tile_j, n), grid=(n // tile_i,),
        in_specs=[vec] * 8, out_specs=(vec, vec),
        out_shape=(jax.ShapeDtypeStruct((1, n), jnp.float32),) * 2,
        interpret=True)
    out = call(*(jnp.asarray(a.reshape(1, n)) for a in arrays))
    return [np.asarray(o).reshape(n) for o in out]


def _port(module, variant, arrays, tile_i, tile_j):
    return [t.numpy() for t in module.probe_forces(
        variant, *(torch.from_numpy(a) for a in arrays), tile_i=tile_i,
        tile_j=tile_j)]


def _kernel_order(module, variant, arrays, tile_i, tile_j):
    return [t.numpy() for t in module.probe_forces_kernel_order(
        variant, *(torch.from_numpy(a) for a in arrays), tile_i=tile_i,
        tile_j=tile_j)]


def _assert_close(got, want):
    scale = max(np.abs(w).max() for w in want)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL * scale)


# ---------------------------------------------------------------------------
# the plain versions against the Pallas probes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile_i, tile_j", [(128, 256), (256, 128)])
@pytest.mark.parametrize("probe, variant", CASES)
def test_plain_matches_pallas(probe, variant, tile_i, tile_j):
    jmod, tmod = PROBES[probe]
    arrays = probe_inputs(N, 0)
    _assert_close(_port(tmod, variant, arrays, tile_i, tile_j),
                  _pallas(jmod.make_kernel, variant, arrays, tile_i, tile_j))


@pytest.mark.parametrize("probe, variant", CASES)
def test_plain_matches_pallas_fed_back(probe, variant):
    """The second call of the probes' loop: the outputs become xi and yi
    (the same arrays for both sides)."""
    jmod, tmod = PROBES[probe]
    arrays = probe_inputs(N, 1)
    xf, yf = _port(tmod, variant, arrays, 128, 256)
    arrays = [xf, yf] + arrays[2:]
    _assert_close(_port(tmod, variant, arrays, 128, 256),
                  _pallas(jmod.make_kernel, variant, arrays, 128, 256))


@pytest.mark.parametrize("probe, variant", CASES)
def test_plain_matches_pallas_square_coincident(probe, variant):
    jmod, tmod = PROBES[probe]
    arrays = probe_inputs(N, 2, square=True)
    _assert_close(_port(tmod, variant, arrays, 128, 256),
                  _pallas(jmod.make_kernel, variant, arrays, 128, 256))


@pytest.mark.parametrize("n, seed, square, tile_i, tile_j", [
    (4096, 6, False, 128, 256), (4096, 6, False, 256, 128),
    (4096, 7, True, 128, 256)])
@pytest.mark.parametrize("probe, variant", CASES)
def test_kernel_order_matches_pallas(probe, variant, n, seed, square, tile_i,
                                     tile_j):
    """The plain version in the kernels' order (the 32 column tiles in
    SPLIT parts, each folded in order, the parts folded in rank order)
    against the Pallas probe at N=4096: only the summation order differs."""
    jmod, tmod = PROBES[probe]
    arrays = probe_inputs(n, seed, square=square)
    _assert_close(_kernel_order(tmod, variant, arrays, tile_i, tile_j),
                  _pallas(jmod.make_kernel, variant, arrays, tile_i, tile_j))


@pytest.mark.parametrize("n, tile_j", [(384, 128), (1152, 384)])
@pytest.mark.parametrize("probe, variant", CASES)
def test_kernel_order_at_ragged_n(probe, variant, n, tile_j):
    """n = 384 and 1152 leave a row block of 128 R = 512 rows part empty,
    and their 3 and 9 column tiles split into SPLIT parts leave the last
    part short: the kernel order still sums every column once (square input
    with coincident bodies, against the Pallas order)."""
    tmod = PROBES[probe][1]
    assert n % (_probe.TILE * _probe.ROWS)
    assert (n // _probe.TILE) % _probe.SPLIT
    arrays = probe_inputs(n, 8, square=True)
    want = [t.numpy() for t in tmod.probe_forces_reference(
        variant, *(torch.from_numpy(a) for a in arrays), tile_i=128,
        tile_j=tile_j)]
    _assert_close(_kernel_order(tmod, variant, arrays, 128, tile_j), want)


def test_kernel_order_folds_parts_in_rank_order():
    """At N=1024 with split 2 the kernels' order is (tiles 0-3) + (tiles
    4-7), each folded tile by tile; the tensor-core variants take no
    split."""
    arrays = [torch.from_numpy(a) for a in probe_inputs(1024, 9)]
    xf, yf = _probe.kernel_order("full", arrays, 128, 128, 2)
    px, py, _ = _probe._tile_sums("full", arrays, 128, 128, 128, False)
    want = []
    for p in (px, py):
        halves = [torch.zeros(1024), torch.zeros(1024)]
        for t in range(8):
            halves[t // 4] = halves[t // 4] + p[:, t]
        want.append((halves[0] + halves[1]) * (arrays[2] * _probe.GRAVITY))
    assert torch.equal(xf, want[0]) and torch.equal(yf, want[1])
    assert [_probe.split_of(v) for v in tbias.VARIANTS] == [
        _probe.SPLIT] * 6 + [1, 1]


def test_layout_constants_match_the_header():
    """_probe.ROWS and SPLIT, which the plain version's order and the
    census's kernel names assume, are kRows and kSplit of
    csrc/probe_layout.cuh."""
    with open(os.path.join(CSRC, "probe_layout.cuh")) as f:
        text = f.read()
    for name, value in (("kRows", _probe.ROWS), ("kSplit", _probe.SPLIT)):
        assert "constexpr int %s = %d;\n" % (name, value) in text


def test_build_hashes_every_header_and_the_defines(tmp_path, monkeypatch):
    """Each library hashes the headers under csrc/ that its sources
    include, directly or through another header, and no other, and every
    header is hashed by some library: a change to one, such as another
    layout's definitions in probe_layout.cuh, builds a new probes library
    instead of loading a stale one, and leaves the step library's hash as
    it is."""
    import re
    import shutil
    from parallel_nbody_tpu_torch.ops import _build

    def includes(name):
        with open(os.path.join(CSRC, name)) as f:
            return set(re.findall(r'#include "([^"]+)"', f.read()))

    hashed = set()
    for files, headers, _ in _build.LIBRARIES.values():
        seen, todo = set(), set(files)
        while todo:
            todo = set().union(*map(includes, todo)) - seen
            seen |= todo
        assert sorted(headers) == sorted(seen)
        hashed |= seen
    assert hashed == {f for f in os.listdir(CSRC) if f.endswith(".cuh")}
    before = {name: _build._library_hash(name) for name in _build.LIBRARIES}
    edited = tmp_path / "csrc"
    shutil.copytree(CSRC, edited)
    layout = edited / "probe_layout.cuh"
    layout.write_text(layout.read_text().replace("kSplit = 2;", "kSplit = 4;"))
    monkeypatch.setattr(_build, "_CSRC", str(edited))
    assert _build._library_hash("probes") != before["probes"]
    assert _build._library_hash("kernels") == before["kernels"]


@pytest.mark.parametrize("variant", [v for v in tbias.VARIANTS if v != "r2"])
def test_bias_variants_tell_apart_on_coincident_input(variant):
    """On the square input, relative to max|F| of r2 (measured: the kicks
    are 1.3e-3 and the self-pair terms up to 5.3e-3 of it):
      - bias2_* and bias_cond differ from r2 on exactly the coincident rows
        (the kick), by more than 1e-4, and agree elsewhere within 1e-6
        (bias_cond's constant 2^-26 moves off-diagonal dx by an ulp or so);
      - bias1_* differ on every row, by more than 1e-5: (0 + 2^-26) turns
        each self-pair into a term;
      - mxu2_r2 is r2 in the plain version (the tf32 rounding is the
        kernel's)."""
    arrays = probe_inputs(N, 2, square=True)
    r2 = _port(tbias, "r2", arrays, 128, 256)
    got = _port(tbias, variant, arrays, 128, 256)
    scale = max(np.abs(w).max() for w in r2)
    diff = np.maximum(*(np.abs(g - w) for g, w in zip(got, r2))) / scale
    if variant in ("bias2_max", "bias2_fma", "bias_cond"):
        assert sorted(np.nonzero(diff > 1e-6)[0]) == COINCIDENT_ROWS
        assert (diff[COINCIDENT_ROWS] > 1e-4).all()
    elif variant in ("bias1_const", "bias1_fma", "bias1_mxu2"):
        assert (diff > 1e-5).all()
    else:
        assert variant == "mxu2_r2"
        assert diff.max() <= 1e-6


def test_coincident_kick_is_the_reference_kick():
    """bias2_fma's extra force on body 7 is the reference's kick from body
    300: m_300 * sign(300 - 7) / (r_7 + r_300)^2 along +x, times
    m_7 * 1.1.  The kick is ~1.3e-3 of max|F|, and the two row sums round
    differently once it is in, by a few fp32 ulps of max|F|: 1e-3 of the
    kick, and 1e-6 of max|F| along y."""
    arrays = probe_inputs(N, 2, square=True)
    r2 = _port(tbias, "r2", arrays, 128, 256)
    got = _port(tbias, "bias2_fma", arrays, 128, 256)
    scale = max(np.abs(w).max() for w in r2)
    m, r = (a.astype(np.float64) for a in (arrays[2], arrays[3]))
    for i, j in ((7, 300), (300, 7), (10, 11), (11, 10)):
        kick = m[j] * np.sign(j - i) / (r[i] + r[j]) ** 2 * m[i] * 1.1
        np.testing.assert_allclose(got[0][i] - r2[0][i], kick, rtol=1e-3)
        assert abs(got[1][i] - r2[1][i]) <= 1e-6 * scale


def test_constants_match_jax():
    assert _probe.BIAS == jbias.BIAS and _probe.CBIAS == jbias.CBIAS


def test_magnitudes_bound_the_forces():
    arrays = [torch.from_numpy(a) for a in probe_inputs(N, 3)]
    for variant in tbias.TF32_VARIANTS:
        xf, yf, xmag, ymag = tbias.probe_forces_reference(
            variant, *arrays, tile_i=128, tile_j=256, magnitudes=True)
        plain = tbias.probe_forces_reference(variant, *arrays, tile_i=128,
                                             tile_j=256)
        assert torch.equal(xf, plain[0]) and torch.equal(yf, plain[1])
        assert bool((xmag >= xf.abs() * (1 - 1e-5)).all())
        assert bool((ymag >= yf.abs() * (1 - 1e-5)).all())


# ---------------------------------------------------------------------------
# the wrappers and entry points on a machine without a card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("probe", sorted(PROBES))
def test_probe_forces_on_cpu_runs_plain_version(probe):
    tmod = PROBES[probe][1]
    arrays = [torch.from_numpy(a) for a in probe_inputs(256, 4)]
    before = tmod.probe_forces.launches
    for variant in tmod.VARIANTS:
        got = tmod.probe_forces(variant, *arrays, tile_i=128, tile_j=128)
        want = tmod.probe_forces_kernel_order(variant, *arrays, tile_i=128,
                                              tile_j=128)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tmod.probe_forces.launches == before


def _bad_inputs(bad):
    """(arrays, keyword arguments) for one way of calling a probe wrong."""
    arrays = [torch.from_numpy(a) for a in probe_inputs(256, 5)]
    kw = dict(tile_i=128, tile_j=128)
    if bad == "float64":
        arrays = [a.double() for a in arrays]
    elif bad == "bf16_one":
        arrays[3] = arrays[3].to(torch.bfloat16)
    elif bad == "ragged_n":
        arrays = [a[:200].contiguous() for a in arrays]
    elif bad == "n_not_multiple_of_tile_j":
        arrays = [torch.cat([a, a[:128]]) for a in arrays]
        kw = dict(tile_i=128, tile_j=256)
    elif bad == "tile_not_multiple_of_128":
        kw = dict(tile_i=64, tile_j=128)
    elif bad == "ragged_column":
        arrays[5] = arrays[5][:128].contiguous()
    elif bad == "row_vector":
        arrays = [a.reshape(1, -1) for a in arrays]
    elif bad == "strided":
        arrays[0] = torch.cat([arrays[0], arrays[0]])[::2]
    elif bad == "meta":
        arrays[2] = arrays[2].to("meta")
    return arrays, kw


@pytest.mark.parametrize("bad", [
    "float64", "bf16_one", "ragged_n", "n_not_multiple_of_tile_j",
    "tile_not_multiple_of_128", "ragged_column", "row_vector", "strided",
    "meta", "unknown_variant"])
@pytest.mark.parametrize("probe", sorted(PROBES))
def test_probe_forces_rejects(probe, bad):
    tmod = PROBES[probe][1]
    arrays, kw = _bad_inputs(bad)
    variant = "bogus" if bad == "unknown_variant" else tmod.VARIANTS[0]
    with pytest.raises((TypeError, ValueError)):
        tmod.probe_forces(variant, *arrays, **kw)
    with pytest.raises((TypeError, ValueError)):
        tmod.probe_forces_reference(variant, *arrays, **kw)
    with pytest.raises((TypeError, ValueError)):
        tmod.probe_forces_kernel_order(variant, *arrays, **kw)


@pytest.mark.parametrize("probe", sorted(PROBES))
def test_main_without_card_exits_1(probe, monkeypatch, capsys):
    tmod = PROBES[probe][1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmod.main(["probe", "1024", "2"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


@pytest.mark.parametrize("probe", sorted(PROBES))
def test_bench_variant_without_card_raises(probe, monkeypatch):
    tmod = PROBES[probe][1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmod.bench_variant(tmod.VARIANTS[0], 1024, 2, 256, 1024)


@pytest.mark.parametrize("probe", sorted(PROBES))
def test_module_entry_point_without_card_exits_1(probe):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "parallel_nbody_tpu_torch.benchmarks." + probe,
         "1024", "2"], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=120)
    assert r.returncode == 1 and r.stdout == ""
    assert "no CUDA device" in r.stderr


# ---------------------------------------------------------------------------
# the SASS census (runs on a listing; cuobjdump and the card are not needed)
# ---------------------------------------------------------------------------

_LISTING = """
	code for sm_90a
		Function : _ZN50_GLOBAL__N__85c3eed4_17_roofline_probe_cu_e431cdf521roofline_probe_kernelILi0EEEvPKfS2_lPfS3_
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
        /*0010*/                   LDG.E R4, desc[UR4][R2.64] ;   /* 0x0 */
        /*0020*/                   STS [R5], R4 ;   /* 0x0 */
        /*0030*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;   /* 0x0 */
        /*0040*/                   LDS.128 R8, [UR4] ;   /* 0x0 */
        /*0050*/                   LDS.64 R12, [UR5] ;   /* 0x0 */
        /*0060*/                   FADD R9, -R3, R9 ;   /* 0x0 */
        /*0070*/                   FFMA R7, R9, R9, R7 ;   /* 0x0 */
        /*0080*/               @!P1 FMUL R7, R7, 16777216 ;   /* 0x0 */
        /*0090*/                   MUFU.RSQ R4, R7 ;   /* 0x0 */
        /*00a0*/                   IADD3 R2, R2, 0x20, RZ ;   /* 0x0 */
        /*00b0*/                @P1 BRA 0x40 ;   /* 0x0 */
        /*00c0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;   /* 0x0 */
        /*00d0*/               @!P0 BRA 0x10 ;   /* 0x0 */
        /*00e0*/                   EXIT ;   /* 0x0 */
        /*00f0*/                   BRA 0xf0;   /* 0x0 */
"""


def _probe_listing(kernel, args, body):
    """A listing of one probe kernel (template arguments ``args`` as
    mangled, e.g. Li0ELi4 for <0, 4>) whose inner loop holds ``body`` (a
    list of instructions) and its backward branch, between two barriers of
    the tile loop."""
    lines = ["\tFunction : _ZN50_GLOBAL__N__85c3eed4_17_roofline_probe_cu_"
             "e431cdf5%d%sI%sEEEvPKfS2_lPfS3_" % (len(kernel), kernel, args),
             "        /*0000*/ BAR.SYNC.DEFER_BLOCKING 0x0 ;"]
    for k, op in enumerate(body + ["@P1 BRA 0x10"]):
        lines.append("        /*%04x*/ %s ;" % (0x10 * (k + 1), op))
    lines.append("        /*%04x*/ BAR.SYNC.DEFER_BLOCKING 0x0 ;"
                 % (0x10 * (len(body) + 2)))
    return "\n".join(lines)


def _row_loop(rows=4, fsetp=0, mufu=True, lds="LDS.128", dropped=0):
    """The body of a scalar probe loop over 8 columns: per column one shared
    load (none for the first ``dropped``), per pair 13 FP32 instructions
    and a MUFU; per pass two loop instructions."""
    body = []
    for column in range(8):
        if column >= dropped:
            body.append("%s R8, [UR4+0x10]" % lds)
        for _ in range(rows):
            body += ["FADD R9, R8, -R3"] * 4 + ["FMUL R7, R9, R9"] * 5
            body += ["FFMA R7, R9, R9, R7"] * 3 + ["FMNMX R7, R7, R5, !PT"]
            body += ["MUFU.RSQ R4, R7"] if mufu else []
    return body + ["FSETP.GEU.AND P0, PT, R7, 1.1754943508222875079e-38, PT"]\
        * fsetp + ["UIADD3 UR4, UR4, 0x80, URZ"]


def test_sass_census_counts_the_inner_loop():
    from parallel_nbody_tpu_torch.benchmarks import sass_census
    rows = sass_census.census(_LISTING)
    assert len(rows) == 1  # the outer loop holds a barrier; 0xf0 is no loop
    name, start, end, pairs, ops = rows[0]
    assert (name, start, end, pairs) == (
        "roofline_probe_kernel<Li0>", 0x40, 0xb0, 8)
    assert ops == {"LDS.128": 1, "LDS.64": 1, "FADD": 1, "FFMA": 1,
                   "FMUL": 1, "MUFU": 1, "IADD3": 1, "BRA": 1}
    assert sass_census.floats_loaded(ops) == 6
    line = sass_census.format_row(rows[0])
    assert "1.000 instr/pair" in line and "FP32  0.375" in line
    assert sass_census.kernel_name(
        "_ZN41_GLOBAL__N__7f641550_9_forces_cu_a6310b9419block_forces_"
        "kernelIfLb0EEEvPKT_") == "block_forces_kernel<fLb0>"


@pytest.mark.parametrize("rows", [2, 4])
def test_sass_census_counts_the_inner_loop_of_r_rows(rows):
    """The redesigned loop: 8 columns of R rows a pass, one LDS.128 a
    column, 13 FP32 instructions and a MUFU a pair, 2 of overhead."""
    from parallel_nbody_tpu_torch.benchmarks import sass_census
    (row,) = sass_census.census(_probe_listing(
        "roofline_probe_kernel", "Li0ELi%d" % rows, _row_loop(rows=rows)))
    name, start, end, pairs, ops = row
    assert (name, start, pairs) == (
        "roofline_probe_kernel<Li0ELi%d>" % rows, 0x10, 8 * rows)
    assert ops["LDS.128"] == 8 and ops["MUFU"] == pairs
    assert sass_census.floats_loaded(ops) == 4 * pairs // rows
    assert sass_census.instr_per_pair(row) == (8 + pairs * 14 + 2) / pairs
    assert sass_census.probe_loop_faults(row) == []
    assert sass_census.pairs_per_pass(
        "bias_probe_kernel<Li3ELi%d>" % rows) == 8 * rows
    assert sass_census.pairs_per_pass("bias_probe_mma_kernel<Lb1>") == 16


@pytest.mark.parametrize("kernel, variant, loop, fault", [
    ("roofline_probe_kernel", 0, dict(), None),
    ("roofline_probe_kernel", 0, dict(dropped=1), "shared floats"),
    ("roofline_probe_kernel", 0, dict(lds="LDS.64"), "shared floats"),
    ("roofline_probe_kernel", 1, dict(mufu=False), None),
    ("roofline_probe_kernel", 0, dict(mufu=False), "MUFU"),
    ("roofline_probe_kernel", 2, dict(lds="LDS.64"), "shared floats"),
    ("roofline_probe_kernel", 3, dict(mufu=False, lds="LDS"),
     "shared floats"),
    ("bias_probe_kernel", 3, dict(), None),
    ("bias_probe_kernel", 0, dict(fsetp=1), "FSETP"),
    ("bias_probe_kernel", 5, dict(rows=2), "MUFU"),
    ("bias_probe_mma_kernel", 0, dict(rows=2, fsetp=32), None),
    ("bias_probe_mma_kernel", 1, dict(rows=2, fsetp=48), "FSETP"),
])
def test_sass_census_probe_loop_faults(kernel, variant, loop, fault):
    """probe_loop_faults passes the intended loop and catches a dropped
    column load (7 LDS.128 for 8 columns, or a narrower load), a pass of
    fewer rows than the kernel's R, and rsqrtf's FSETP; the tensor-core
    kernel (16 pairs a pass) may hold one FSETP for each of its two tf32
    conversions a pair, and no more."""
    from parallel_nbody_tpu_torch.benchmarks import sass_census
    args = ("Lb%d" % variant if kernel == "bias_probe_mma_kernel"
            else "Li%dELi4" % variant)
    (row,) = sass_census.census(_probe_listing(kernel, args,
                                               _row_loop(**loop)))
    faults = sass_census.probe_loop_faults(row)
    if fault is None:
        assert faults == []
    else:
        assert len(faults) == 1 and fault in faults[0]


@pytest.mark.parametrize("probe, variant", CASES)
def test_probe_kernel_name_is_the_census_name(probe, variant):
    """probe_kernel_name gives the name kernel_name reads off the mangled
    symbol of the kernel the variant launches, and the census takes a pass
    of that kernel as 8 columns of _probe.ROWS rows (16 pairs for the
    tensor-core kernel)."""
    from parallel_nbody_tpu_torch.benchmarks import sass_census
    name = sass_census.probe_kernel_name(probe, variant)
    if variant in _probe.TF32_VARIANTS:
        args = "Lb%d" % (variant == "bias1_mxu2")
        template, pairs = "bias_probe_mma_kernel", 16
    else:
        index = (troof if probe == troof.NAME else tbias).VARIANTS.index(
            variant)
        args = "Li%dELi%d" % (index, _probe.ROWS)
        template = ("roofline_probe_kernel" if probe == troof.NAME
                    else "bias_probe_kernel")
        pairs = 8 * _probe.ROWS
    mangled = "_ZN4_GLOBAL__%d%sI%sEEEvPKf" % (len(template), template, args)
    assert sass_census.kernel_name(mangled) == name
    assert sass_census.pairs_per_pass(name) == pairs


def test_ptxas_registers_reads_the_build_log():
    from parallel_nbody_tpu_torch.benchmarks import sass_census
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__85c3eed4_17_roofline_probe_cu_e431cdf521roofline_probe_kernelILi0ELi4EEEvPKfS2_lPfS3_' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__85c3eed4_17_roofline_probe_cu_e431cdf521roofline_probe_kernelILi0ELi4EEEvPKfS2_lPfS3_
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 6144 bytes smem
ptxas info    : Compiling entry function '_ZN4_GLOBAL__17bias_probe_mma_kernelILb1EEEvPKf' for 'sm_90a'
ptxas info    : Used 40 registers, used 1 barriers, 2048 bytes smem
"""
    assert sass_census.ptxas_registers(log) == {
        "roofline_probe_kernel<Li0ELi4>": (64, 8),
        "bias_probe_mma_kernel<Lb1>": (40, 0)}


def _force_listing(loops):
    """A listing of one K1 instantiation whose inner loops hold the given
    opcodes (each loop also gets an LDS.128 and its backward branch)."""
    lines = ["\tFunction : _ZN41_GLOBAL__N__7f641550_9_forces_cu_a6310b94"
             "19block_forces_kernelIfLb0EEEvPKT_"]
    addr = 0
    for body in loops:
        start = addr
        for op in ["LDS.128 R8, [UR4]"] + body + ["@P1 BRA 0x%x" % start]:
            lines.append("        /*%04x*/ %s ;" % (addr, op))
            addr += 0x10
        lines.append("        /*%04x*/ BAR.SYNC.DEFER_BLOCKING 0x0 ;" % addr)
        addr += 0x10
    return "\n".join(lines)


def test_sass_census_tells_the_force_loops_apart():
    """K1's three pair loops: the one with the int-to-float conversion is
    the per-pair bias; of the others the longer adds the constant bias."""
    from parallel_nbody_tpu_torch.benchmarks import sass_census
    per_pair = ["I2FP.F32.S32 R3, R3", "FADD R9, -R3, R9",
                "FFMA R9, R3, R4, R9", "MUFU.RSQ R4, R7"]
    const = ["FADD R9, -R3, R9", "FADD R9, R9, R5", "MUFU.RSQ R4, R7"]
    unbiased = ["FADD R9, -R3, R9", "MUFU.RSQ R4, R7"]
    rows = sass_census.census(_force_listing([const, per_pair, unbiased]))
    roles = sass_census.loop_roles(rows)
    assert [roles[r[0], r[1]] for r in rows] == [
        "constant bias", "per-pair bias", "unbiased"]
    assert [sass_census.instr_per_pair(r) for r in rows] == [
        5 / 8, 6 / 8, 4 / 8]
    assert "per-pair bias" in sass_census.format_row(rows[1], "per-pair bias")
    # Two loops of one length, or no conversion: no roles.
    for loops in ([unbiased, unbiased, per_pair], [unbiased, const]):
        assert sass_census.loop_roles(
            sass_census.census(_force_listing(loops))) == {}
