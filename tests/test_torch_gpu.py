"""Tests of the CUDA kernels on the card (marker ``gpu``; they skip without
one).  This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

Tolerances: each kernel (K1 ``block_forces``, K2 ``block_forces_streamed``)
against its plain version on the same card is held to 2e-6 * max|F| in fp32,
chip_smoke.TOL (both sum each 128-column tile into a partial and fold the
partials in order; they differ only inside a tile, below 3e-7 * max|F| on
the H100 up to N=2097152, where one running sum over a row of 65536 columns
reached ~4.9e-6) and 1e-12 * max|F| in fp64.  The magnitude-spread case
keeps the bounds of tests/test_accum.py; bf16 launches are bit-equal to the
fp32 launch on the upcast inputs rounded once.  The probe kernels (P1, P2)
at N=384, 1152 and 4096 against their plain versions in the kernels' order
(``probe_forces_kernel_order``): 2e-5 * max|F| for the fp32 variants
(chip_smoke.TOL), and for the two tensor-core variants, which round each
term to tf32 (2^-11 relative), the per-row bound
|err_i| <= 2^-10 * |G m_i| * sum_j |term_ij|.  The parity pass (trig, fp64)
against the dense trig path and its plain version on the card: none, bit
for bit.
"""

import os

import numpy as np
import pytest
import torch

from parallel_nbody_tpu_torch import cli
from parallel_nbody_tpu_torch.benchmarks import _probe
from parallel_nbody_tpu_torch.benchmarks import bias_variants_probe as p2
from parallel_nbody_tpu_torch.benchmarks import roofline_probe as p1
from parallel_nbody_tpu_torch.config import SimConfig
from parallel_nbody_tpu_torch.models.engine import run
from parallel_nbody_tpu_torch.ops import cuda_step
from parallel_nbody_tpu_torch.state import init_state, random_state
from parallel_nbody_tpu_torch.utils import ppm
from torch_cases import (BLOCK_CASES, KICK, KICK_PLACEMENTS, SEGMENT_CASES,
                         blocks, glibc_like, kick_case, probe_inputs,
                         segment_blocks, trig_bodies)

TOL = {"float32": 2e-6, "float64": 1e-12}

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _on(arrays, dtype, dev):
    return [torch.tensor(a, dtype=getattr(torch, dtype), device=dev)
            for a in arrays]


@pytest.mark.parametrize("biased", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", BLOCK_CASES)
def test_kernel_matches_reference(case, dtype, biased, dev):
    rows, cols, g0, c0 = blocks(case)
    rows, cols = _on(rows, dtype, dev), _on(cols, dtype, dev)
    cfg = SimConfig(force_mode="fast", dtype=dtype, kernel="cuda")
    before = cuda_step.block_forces.launches
    got = cuda_step.block_forces(cfg, *rows, *cols, row_g0=g0, col_g0=c0,
                                 biased=biased)
    torch.cuda.synchronize()
    assert cuda_step.block_forces.launches == before + 1
    want = cuda_step.block_forces_reference(cfg, *rows, *cols, row_g0=g0,
                                            col_g0=c0, biased=biased)
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert g.device == dev and g.dtype == w.dtype
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0,
                                   atol=TOL[dtype] * scale)


@pytest.mark.parametrize("biased", [True, False])
@pytest.mark.parametrize("case", ["square300", "zero_mass"])
def test_one_sided_kernel_matches_reference_on_square_blocks(case, biased,
                                                             dev):
    """K1 itself on the fp32 square blocks, which block_forces hands to the
    symmetric pass: block_forces_one_sided launches it, counts nothing, and
    stays within the bound of its plain version."""
    rows, cols, g0, c0 = blocks(case)
    rows, cols = _on(rows, "float32", dev), _on(cols, "float32", dev)
    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
    before = (cuda_step.block_forces.launches,
              cuda_step.block_forces.symmetric_launches)
    got = cuda_step.block_forces_one_sided(cfg, *rows, *cols, row_g0=g0,
                                           col_g0=c0, biased=biased)
    torch.cuda.synchronize()
    assert (cuda_step.block_forces.launches,
            cuda_step.block_forces.symmetric_launches) == before
    want = cuda_step.block_forces_reference(cfg, *rows, *cols, row_g0=g0,
                                            col_g0=c0, biased=biased)
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0,
                                   atol=TOL["float32"] * scale)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_kernel_two_body_kick_and_device_flag(dtype, dev):
    cfg = SimConfig(force_mode="fast", dtype=dtype, kernel="cuda")
    b = _on([[100.0, 100.0], [200.0, 200.0], [5.0, 7.0], [1.5, 1.5]], dtype,
            dev)
    for flag in (True, torch.ones((), dtype=torch.bool, device=dev)):
        xf, yf = cuda_step.block_forces(cfg, *b, *b, biased=flag)
        np.testing.assert_allclose(xf.cpu().numpy(), [KICK, -KICK],
                                   rtol=1e-6)
        np.testing.assert_array_equal(yf.cpu().numpy(), [0.0, 0.0])
    off = torch.zeros((), dtype=torch.bool, device=dev)
    xf, _ = cuda_step.block_forces(cfg, *b, *b, biased=off)
    np.testing.assert_array_equal(xf.cpu().numpy(), [0.0, 0.0])


def test_kernel_rejects_mixed_devices(dev):
    b = _on([[1.0, 2.0]] * 4, "float32", dev)
    cpu = [t.cpu() for t in b]
    with pytest.raises(ValueError):
        cuda_step.block_forces(SimConfig(), *b, *cpu, biased=False)
    with pytest.raises(ValueError):
        cuda_step.block_forces(SimConfig(), *b, *b,
                               biased=torch.tensor(True))


def test_any_coincident_on_card(dev):
    cfg = SimConfig(dtype="float32")
    st = init_state(4096, cfg, device=dev)
    flag = cuda_step.any_coincident(st.x, st.y, st.mass)
    assert flag.device == st.x.device and bool(flag)
    host = init_state(4096, cfg)
    assert bool(cuda_step.any_coincident(host.x, host.y, host.mass))


def test_engine_on_card_matches_cpu(dev):
    """fp64, 20 steps at N=300 from the glibc init (coincident pairs on step
    1): the kernel path on the card against its plain version on the CPU."""
    cfg = SimConfig(force_mode="fast", dtype="float64", kernel="cuda")
    want = run(cfg, init_state(300, cfg), 20)
    cuda_step.block_forces.launches = 0
    got = run(cfg, init_state(300, cfg, device=dev), 20)
    assert cuda_step.block_forces.launches == 20
    for f in ("x", "y", "xv", "yv", "xf", "yf"):
        w = getattr(want, f).numpy()
        np.testing.assert_allclose(getattr(got, f).cpu().numpy(), w,
                                   rtol=1e-9, atol=1e-9 * np.abs(w).max(),
                                   err_msg=f)


def test_cli_on_card_goes_through_kernel(dev, tmp_path, capsys,
                                         monkeypatch):
    arena = str(tmp_path / "arena.ppm")
    ppm.create(arena, 1024, 768)
    monkeypatch.setenv("NBODY_PLATFORM", "cuda")
    cuda_step.block_forces.launches = 0
    rc = cli.main(["nbody", "1024", "0", arena, "10", "--pallas",
                   "--dtype=float64"])
    out = capsys.readouterr().out
    assert rc == 0
    assert cuda_step.block_forces.launches >= 10
    cfg = SimConfig(force_mode="fast", dtype="float64", kernel="cuda")
    want = run(cfg, init_state(1024, cfg), 10)
    got = np.array([[float(v) for v in line.split()]
                    for line in out.splitlines()]).T
    for row, f in zip(got, ("x", "y", "xf", "yf", "xv", "yv")):
        np.testing.assert_allclose(row, getattr(want, f).numpy(), rtol=0,
                                   atol=2e-3, err_msg=f)


# ---------------------------------------------------------------------------
# K2, compensated accumulation and bf16 storage
# ---------------------------------------------------------------------------

def _k2_case(case):
    """(rows, cols, row_g0, col_g0, band) for K2 on the card."""
    if case == "bands_ragged":
        b = glibc_like(4097, 21, ((5, 4000), (1024, 1025), (3000, 3001)))
        return b, b, 0, 0, 1024
    if case == "offsets_cross_band":
        # Rows are bodies 1000..2999, columns 500..4095 of one set: the band
        # edges at column 1024 and 2048 (bodies 1524, 2548) cut through the
        # rows, and a coincident pair straddles the first.
        full = glibc_like(4096, 22, ((1500, 1600), (2000, 3500)))
        return ([a[1000:3000] for a in full], [a[500:] for a in full],
                1000, 500, 1024)
    rows, cols, g0, c0 = blocks(case)
    return rows, cols, g0, c0, 128


K2_CASES = ("bands_ragged", "offsets_cross_band") + BLOCK_CASES


@pytest.mark.parametrize("accum", ["plain", "compensated"])
@pytest.mark.parametrize("biased", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", K2_CASES)
def test_streamed_kernel_matches_reference(case, dtype, biased, accum, dev):
    rows, cols, g0, c0, band = _k2_case(case)
    rows, cols = _on(rows, dtype, dev), _on(cols, dtype, dev)
    cfg = SimConfig(force_mode="fast", dtype=dtype, kernel="cuda")
    before = cuda_step.block_forces_streamed.launches
    got = cuda_step.block_forces_streamed(cfg, *rows, *cols, row_g0=g0,
                                          col_g0=c0, band=band,
                                          biased=biased, accum=accum)
    torch.cuda.synchronize()
    assert cuda_step.block_forces_streamed.launches == before + 1
    want = cuda_step.block_forces_streamed_reference(
        cfg, *rows, *cols, row_g0=g0, col_g0=c0, band=band, biased=biased,
        accum=accum)
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert g.device == dev and g.dtype == w.dtype
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0,
                                   atol=TOL[dtype] * scale)


@pytest.mark.parametrize("biased", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_compensated_kernel_matches_reference(dtype, biased, dev):
    rows, cols, g0, c0 = blocks("rect256x384")
    rows, cols = _on(rows, dtype, dev), _on(cols, dtype, dev)
    cfg = SimConfig(force_mode="fast", dtype=dtype, kernel="cuda")
    got = cuda_step.block_forces(cfg, *rows, *cols, row_g0=g0, col_g0=c0,
                                 biased=biased, accum="compensated")
    want = cuda_step.block_forces_reference(cfg, *rows, *cols, row_g0=g0,
                                            col_g0=c0, biased=biased,
                                            accum="compensated")
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0,
                                   atol=TOL[dtype] * scale)


@pytest.mark.parametrize("kernel", ["block_forces", "block_forces_streamed"])
def test_compensated_magnitude_spread_on_card(kernel, dev):
    """tests/test_accum.py:24-84 on the card: the Kahan folds survive the
    compiler."""
    n_cols = 4096
    mj = np.full(n_cols, 0.9 / 128)
    mj[0] = 2.0 ** 24
    args = _on([[0.0], [0.0], [1.0], [0.1], np.ones(n_cols),
                np.zeros(n_cols), mj, np.full(n_cols, 0.1)], "float32", dev)
    exact = 1.1 * (2.0 ** 24 + (n_cols - 1) * (0.9 / 128))
    fn = getattr(cuda_step, kernel)
    kw = dict(band=128) if kernel == "block_forces_streamed" else {}
    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")

    def err(accum):
        fx, _ = fn(cfg, *args, row_g0=0, col_g0=8192, biased=False,
                   accum=accum, **kw)
        return abs(float(fx[0]) - exact) / exact

    assert err("plain") > 5e-7
    assert err("compensated") < 3e-7


@pytest.mark.parametrize("accum", ["plain", "compensated"])
@pytest.mark.parametrize("biased", [True, False])
@pytest.mark.parametrize("kernel", ["block_forces", "block_forces_streamed"])
def test_bf16_kernel_is_fp32_kernel_rounded_once(kernel, biased, accum,
                                                 dev):
    b = [t.to(torch.bfloat16) for t in _on(glibc_like(4097, 23),
                                           "float32", dev)]
    b32 = [t.float() for t in b]
    fn = getattr(cuda_step, kernel)
    kw = dict(band=1024) if kernel == "block_forces_streamed" else {}
    cfg = SimConfig(force_mode="fast", kernel="cuda")
    got = fn(cfg.replace(dtype="bfloat16"), *b, *b, biased=biased,
             accum=accum, **kw)
    want = fn(cfg.replace(dtype="float32"), *b32, *b32, biased=biased,
              accum=accum, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# the segmented dx bias
# ---------------------------------------------------------------------------

SEGMENT_CARD_CASES = (tuple("kick_" + p for p in sorted(KICK_PLACEMENTS))
                      + tuple("segments_" + c for c in sorted(SEGMENT_CASES)))


def _segment_case(case):
    """(rows, cols, row_g0, col_g0, band) of a coincident pair in each bias
    segment (KICK_PLACEMENTS, offsets 37 and 90 in the misaligned ones), or
    the N=2300 set with pairs in every segment, its rows from 0 or from
    600 (not a multiple of 128)."""
    if case.startswith("kick_"):
        rows, cols, g0, c0, _ = kick_case(case[len("kick_"):])
        return rows, cols, g0, c0, 256
    rows, cols, g0, c0 = segment_blocks(case[len("segments_"):])
    return rows, cols, g0, c0, 1024


@pytest.mark.parametrize("accum", ["plain", "compensated"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("kernel", ["block_forces", "block_forces_streamed"])
@pytest.mark.parametrize("case", SEGMENT_CARD_CASES)
def test_segmented_bias_kernel_matches_reference(case, kernel, dtype, accum,
                                                 dev):
    """The biased kernels against their plain versions where the bias
    segments matter.  fp32/fp64 within TOL; bf16 within TOL plus one bf16
    rounding (2^-7 of the value), since both round their fp32 sums once."""
    rows, cols, g0, c0, band = _segment_case(case)
    rows, cols = _on(rows, dtype, dev), _on(cols, dtype, dev)
    cfg = SimConfig(force_mode="fast", dtype=dtype, kernel="cuda")
    kw = dict(row_g0=g0, col_g0=c0, biased=True, accum=accum)
    if kernel == "block_forces_streamed":
        kw["band"] = band
    fn = getattr(cuda_step, kernel)
    before = fn.launches
    got = fn(cfg, *rows, *cols, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = getattr(cuda_step, kernel + "_reference")(cfg, *rows, *cols, **kw)
    scale = max(float(w.float().abs().max()) for w in want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        g, w = g.double().cpu().numpy(), w.double().cpu().numpy()
        tol = TOL.get(dtype, TOL["float32"]) * scale
        if dtype == "bfloat16":
            tol = tol + 2.0 ** -7 * np.abs(w)
        assert (np.abs(g - w) <= tol).all()
    if case.startswith("kick_"):
        _, _, _, _, (ia, ib) = kick_case(case[len("kick_"):])
        xf = got[0].double().cpu().numpy()
        rtol = 2.0 ** -7 if dtype == "bfloat16" else 1e-6
        np.testing.assert_allclose(xf[[ia, ib]], [KICK, -KICK], rtol=rtol)


@pytest.mark.parametrize("accum", ["plain", "compensated"])
@pytest.mark.parametrize("kernel", ["block_forces", "block_forces_streamed"])
def test_fp32_unbiased_kernel_matches_fp64_pair_terms(kernel, accum, dev):
    """The fp32 unbiased kernel (the bare MUFU rsqrt) against the same
    bias-free pair terms evaluated in float64 on the same fp32 inputs:
    within chip_smoke.py's 2e-5 * max|F| for fp32 sums with rsqrtf (2 ulp
    per term)."""
    b = _on(glibc_like(4097, 26, ((1, 2), (100, 4000))), "float32", dev)
    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
    kw = dict(band=1024) if kernel == "block_forces_streamed" else {}
    got = getattr(cuda_step, kernel)(cfg, *b, *b, biased=False, accum=accum,
                                     **kw)
    b64 = [t.double() for t in b]
    want = getattr(cuda_step, kernel + "_reference")(
        cfg.replace(dtype="float64"), *b64, *b64, biased=False, accum=accum,
        **kw)
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert float((g.double() - w).abs().max()) <= 2e-5 * scale


def test_cuda_forces_dispatch_on_card(dev, monkeypatch):
    """With the threshold lowered to 1024, N=1024 launches K1 and N=1100
    launches K2 (band 65536, one ragged band), each within tolerance of the
    other's plain version."""
    monkeypatch.setattr(cuda_step, "STREAMED_ABOVE", 1024)
    cfg = SimConfig(force_mode="fast", dtype="float64", kernel="cuda")
    for n, name in ((1024, "block_forces"), (1100, "block_forces_streamed")):
        b = _on(glibc_like(n, 24), "float64", dev)
        counts = (cuda_step.block_forces.launches,
                  cuda_step.block_forces_streamed.launches)
        got = cuda_step.cuda_forces(cfg, *b, biased=True)
        after = (cuda_step.block_forces.launches,
                 cuda_step.block_forces_streamed.launches)
        assert [a - c for a, c in zip(after, counts)] == (
            [1, 0] if name == "block_forces" else [0, 1])
        want = cuda_step.block_forces_reference(cfg, *b, *b, biased=True)
        scale = max(float(w.abs().max()) for w in want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       rtol=0, atol=1e-12 * scale)


def test_cli_bf16_compensated_on_card(dev, tmp_path, capsys, monkeypatch):
    arena = str(tmp_path / "arena.ppm")
    ppm.create(arena, 1024, 768)
    monkeypatch.setenv("NBODY_PLATFORM", "cuda")
    rc = cli.main(["nbody", "512", "0", arena, "5", "--pallas",
                   "--dtype=bfloat16", "--accum=compensated"])
    out = capsys.readouterr().out
    assert rc == 0
    table = np.array([[float(v) for v in line.split()]
                      for line in out.splitlines()])
    assert table.shape == (512, 6) and np.isfinite(table).all()


# ---------------------------------------------------------------------------
# the probes P1 and P2
# ---------------------------------------------------------------------------

PROBES = {"roofline_probe": p1, "bias_variants_probe": p2}
PROBE_CASES = [(name, v) for name, m in PROBES.items() for v in m.VARIANTS]


def _probe_args(case, dev):
    """(arrays on the card, tiles) for one probe input: N=4096, or N=384
    and 1152, which neither the row block (512 rows) nor the column split
    (``_probe.SPLIT`` parts of whole 128-column tiles) divides."""
    if case == "independent":
        return _on(probe_inputs(4096, 30), "float32", dev), {}
    if case == "square_coincident":
        return (_on(probe_inputs(4096, 31, square=True), "float32", dev),
                dict(tile_i=128, tile_j=256))
    if case == "ragged_384":
        return (_on(probe_inputs(384, 32), "float32", dev),
                dict(tile_i=128, tile_j=128))
    if case == "ragged_1152_square":
        return (_on(probe_inputs(1152, 33, square=True), "float32", dev),
                dict(tile_i=128, tile_j=384))
    raise ValueError(case)


def _assert_probe_close(module, variant, got, args, tiles):
    *want, xmag, ymag = module.probe_forces_kernel_order(
        variant, *args, magnitudes=True, **tiles)
    scale = max(float(w.abs().max()) for w in want)
    for g, w, mag in zip(got, want, (xmag, ymag)):
        assert g.device == w.device and g.dtype == torch.float32
        assert bool(torch.isfinite(g).all())
        if variant in p2.TF32_VARIANTS:
            assert bool(((g - w).abs() <= 2.0 ** -10 * mag).all())
        else:
            assert float((g - w).abs().max()) <= 2e-5 * scale


@pytest.mark.parametrize("case", ["independent", "square_coincident",
                                  "fed_back", "ragged_384",
                                  "ragged_1152_square"])
@pytest.mark.parametrize("probe, variant", PROBE_CASES)
def test_probe_kernel_matches_reference(probe, variant, case, dev):
    module = PROBES[probe]
    args, tiles = _probe_args("independent" if case == "fed_back" else case,
                              dev)
    if case == "fed_back":
        xf, yf = module.probe_forces(variant, *args, **tiles)
        args = [xf, yf] + args[2:]
    before = module.probe_forces.launches
    got = module.probe_forces(variant, *args, **tiles)
    torch.cuda.synchronize()
    assert module.probe_forces.launches == before + 1
    _assert_probe_close(module, variant, got, args, tiles)


@pytest.mark.parametrize("probe, variant", PROBE_CASES)
def test_probe_forces_counts_one_launch_per_call(probe, variant, dev):
    module = PROBES[probe]
    args, tiles = _probe_args("ragged_384", dev)
    before = module.probe_forces.launches
    xf, yf = module.probe_forces(variant, *args, **tiles)
    torch.cuda.synchronize()
    assert module.probe_forces.launches == before + 1
    assert xf.device == dev and xf.shape == yf.shape == (384,)


@pytest.mark.parametrize("probe", sorted(PROBES))
def test_probe_forces_launches_on_card_never_plain(probe, dev, monkeypatch):
    module = PROBES[probe]

    def plain(*a, **kw):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(_probe, "reference", plain)
    monkeypatch.setattr(_probe, "kernel_order", plain)
    args, _ = _probe_args("independent", dev)
    before = module.probe_forces.launches
    for variant in module.VARIANTS:
        module.probe_forces(variant, *args)
    torch.cuda.synchronize()
    assert module.probe_forces.launches == before + len(module.VARIANTS)


@pytest.mark.parametrize("probe, runs", [("roofline_probe", 2),
                                         ("bias_variants_probe", 4)])
def test_probe_main_on_card(probe, runs, dev, capsys):
    """The probe's main() at a small size: the device line, then one line
    per variant in the JAX probe's format, every step through the
    kernel."""
    module = PROBES[probe]
    module.probe_forces.launches = 0
    assert module.main([probe, "4096", "3"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 + len(module.VARIANTS)
    base = module.VARIANTS[0]
    for variant, line in zip(module.VARIANTS, lines[1:]):
        words = line.split()
        assert words[0] == variant and words[2] == "ms/step"
        assert float(words[1]) > 0 and line.endswith("of %s)" % base)
    assert module.probe_forces.launches == len(module.VARIANTS) * runs * 3


# ---------------------------------------------------------------------------
# the CLI on the card: frames, checkpoints, --check-nans, --trace
# ---------------------------------------------------------------------------

def _cli_on_card(argv, capsys, monkeypatch, env=None):
    monkeypatch.setenv("NBODY_PLATFORM", "cuda")
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    capsys.readouterr()
    rc = cli.main(["nbody"] + argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.fixture
def arena(tmp_path):
    p = str(tmp_path / "arena.ppm")
    ppm.create(p, 256, 192)
    return p


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n, steps", [(300, 0), (300, 5), (4096, 2)])
def test_render_frame_on_card_equals_cpu(n, steps, dtype, dev):
    """Frames byte-equal between the devices from the same tensors, and
    under another chunking (every op of the hit test is correctly rounded
    on both, and eager ops are not contracted)."""
    from parallel_nbody_tpu_torch.ops.render import render_frame
    cfg = SimConfig(xdim=256, ydim=192, force_mode="fast", dtype=dtype,
                    kernel="cuda")
    st = run(cfg, init_state(n, cfg, device=dev), steps)
    b = (st.x, st.y, st.radius)
    card = render_frame(cfg, *b, n)
    assert card.device == dev and card.dtype == torch.uint8
    host = render_frame(cfg, *(t.cpu() for t in b), n)
    assert torch.equal(card.cpu(), host) and bool(host.any())
    assert torch.equal(render_frame(cfg, *b, n, 7, 33), card)
    assert torch.equal(render_frame(cfg, *b, n - 9, 50), render_frame(
        cfg, *(t.cpu() for t in b), n - 9).to(dev))


def test_render_frame_peak_memory_is_bounded(dev):
    """The default body chunk keeps a frame's allocations within the budget
    of the hit temporaries (plus the index map and the tint's planes),
    whatever N is."""
    from parallel_nbody_tpu_torch.ops import render
    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
    st = init_state(16384, cfg, device=dev)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    render.render_frame(cfg, st.x, st.y, st.radius, 16384)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    assert peak <= render.HIT_BUDGET_BYTES + 32 * 2**20


@pytest.mark.parametrize("biased", [False, True])
def test_hosted_row_step_on_card_is_engine_step(biased, dev):
    """The row-chunked step (K2 in chunks of 65536 rows, a tail of 77) is
    engine.step's one K2 launch bit for bit: each row sums its columns band
    by band in an order that does not depend on the rows in the launch, and
    chunks that start at multiples of 128 keep the bias segments.  With
    ``biased`` a coincident pair spans two chunks."""
    from parallel_nbody_tpu_torch.models import engine
    n = 262144 + 77
    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
    st = random_state(n, cfg, torch.Generator(device=dev).manual_seed(0),
                      device=dev)
    if biased:
        x, y = st.x.clone(), st.y.clone()
        x[200000], y[200000] = x[5], y[5]
        st = st._replace(x=x, y=y)
    assert bool(cuda_step.any_coincident(st.x, st.y, st.mass)) == biased
    step_fn, warmup = engine.make_hosted_row_step(cfg, n, row_chunk=65536)
    warmup()
    before = cuda_step.block_forces_streamed.launches
    got = step_fn(st)
    torch.cuda.synchronize()
    assert cuda_step.block_forces_streamed.launches == before + 5
    want = engine.step(cfg, st)
    for f in ("x", "y", "xv", "yv", "xf", "yf"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_cuda_forces_row_launches_on_card(dev, monkeypatch):
    """cuda_forces with K2_WORKSPACE_BYTES lowered to hold 65536 rows a
    launch (5 launches at N=262144+77) gives its one launch's forces bit
    for bit."""
    n = 262144 + 77
    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
    st = random_state(n, cfg, torch.Generator(device=dev).manual_seed(1),
                      device=dev)
    b = (st.x, st.y, st.mass, st.radius)
    flag = cuda_step.any_coincident(st.x, st.y, st.mass)
    want = cuda_step.cuda_forces(cfg, *b, biased=flag)
    bands = -(-n // cuda_step.STREAM_BAND)
    monkeypatch.setattr(cuda_step, "K2_WORKSPACE_BYTES", 65536 * bands * 8)
    before = cuda_step.block_forces_streamed.launches
    got = cuda_step.cuda_forces(cfg, *b, biased=flag)
    torch.cuda.synchronize()
    assert cuda_step.block_forces_streamed.launches == before + 5
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_render_frame_hosted_on_card_is_render_frame(dev):
    """Body chunks of 20000 at N=65536 with 536 padding bodies: the same
    bytes as render_frame, on the card."""
    from parallel_nbody_tpu_torch.ops import render
    n = 65536
    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
    st = init_state(n, cfg, device=dev)
    b = (st.x, st.y, st.radius)
    got = render.render_frame_hosted(cfg, *b, n - 536, body_chunk=20000)
    want = render.render_frame(cfg, *b, n - 536).cpu().numpy()
    assert got.tobytes() == want.tobytes() and got.any()


def test_cli_frames_on_card_do_not_move_the_state(dev, arena, tmp_path,
                                                  capsys, monkeypatch):
    log = str(tmp_path / "frames.log")
    argv = ["2048", "1", arena, "200", "--pallas"]
    cuda_step.block_forces.launches = 0
    rc, out, err = _cli_on_card(argv, capsys, monkeypatch,
                                {"NBODY_FRAME_LOG": log})
    assert rc == 0, err
    # Every step, the warm-up step and the cadence probe's step.
    assert cuda_step.block_forces.launches == 202
    with open(log) as f:
        assert len(f.read().splitlines()) >= 1
    assert ppm.read_pixels(ppm.read_header(arena)).any()
    monkeypatch.delenv("NBODY_FRAME_LOG")
    argv[1] = "0"
    rc, plain, _ = _cli_on_card(argv, capsys, monkeypatch)
    assert rc == 0 and out == plain


@pytest.mark.parametrize("flags", [["--pallas"], ["--fast"],
                                   ["--pallas", "--dtype=bfloat16"]])
def test_cli_checkpoint_resume_on_card(flags, dev, arena, tmp_path, capsys,
                                       monkeypatch):
    """Checkpoint at 12 steps, resume to 30: stdout byte-equal to the
    uninterrupted run; a resume past the target runs nothing and records
    the true step; the file loads onto the card in the run's dtype."""
    from parallel_nbody_tpu_torch.utils import checkpoint as ckpt
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    base = ["1024", "0", arena]
    _, full, _ = _cli_on_card(base + ["30"] + flags, capsys, monkeypatch)
    rc, first, err = _cli_on_card(base + ["12", "--checkpoint=" + a] + flags,
                                  capsys, monkeypatch)
    assert rc == 0, err
    rc, resumed, err = _cli_on_card(base + ["30", "--resume=" + a] + flags,
                                    capsys, monkeypatch)
    assert rc == 0, err
    assert resumed == full and first != full
    cuda_step.block_forces.launches = 0
    rc, _, _ = _cli_on_card(base + ["5", "--resume=" + a, "--checkpoint=" + b]
                            + flags, capsys, monkeypatch)
    assert rc == 0 and cuda_step.block_forces.launches == 0
    st, step = ckpt.load_state(b, dev, torch.float32)
    assert step == 12 and st.x.device == dev and st.x.dtype == torch.float32
    with np.load(a) as za, np.load(b) as zb:
        for k in za.files:
            assert za[k].tobytes() == zb[k].tobytes(), k


def test_cli_check_nans_on_card(dev, arena, tmp_path, capsys, monkeypatch):
    argv = ["1024", "0", arena, "10", "--pallas"]
    _, plain, _ = _cli_on_card(argv, capsys, monkeypatch)
    rc, out, err = _cli_on_card(argv + ["--check-nans"], capsys, monkeypatch)
    assert rc == 0 and out == plain
    assert "State validation ok: max|v|=" in err and "in_bounds=True" in err
    ck, bad = str(tmp_path / "c.npz"), str(tmp_path / "bad.npz")
    _cli_on_card(argv + ["--checkpoint=" + ck], capsys, monkeypatch)
    with np.load(ck) as z:
        fields = {k: z[k].copy() for k in z.files}
    fields["yv"][3] = np.nan
    np.savez(bad, **fields)
    rc, out, err = _cli_on_card(argv + ["--resume=" + bad, "--check-nans"],
                                capsys, monkeypatch)
    assert rc == 1 and out == ""
    assert "State validation FAILED: NaNs in yv\n" in err
    argv[3] = "14"
    with pytest.raises(FloatingPointError, match=r"yv after step 11$"):
        _cli_on_card(argv + ["--resume=" + bad, "--check-nans"], capsys,
                     monkeypatch)


def test_cli_trace_on_card_holds_device_kernels(dev, arena, tmp_path, capsys,
                                                monkeypatch):
    import glob
    import gzip
    import json
    d = str(tmp_path / "trace")
    argv = ["1024", "0", arena, "10", "--pallas"]
    _, plain, _ = _cli_on_card(argv, capsys, monkeypatch)
    rc, out, err = _cli_on_card(argv + ["--trace=" + d], capsys, monkeypatch)
    assert rc == 0 and out == plain
    assert "(0.00%% share) -> %s" % d in err
    (path,) = glob.glob(d + "/*.trace.json.gz")
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    # The fp32 force pass of one block against itself is the symmetric
    # kernel and its fold (cuda_step.takes_symmetric): one of each a step.
    for kernel in ("block_forces_symmetric_kernel", "band_fold_kernel"):
        found = [e for e in events if e.get("cat") == "kernel"
                 and kernel in e["name"]]
        assert len(found) == 10 and all(e["dur"] > 0 for e in found)


def test_step_spans_on_card_hold_every_launch(dev, tmp_path):
    """20 steps at N=65536 in fp32 under ``utils.timing.trace``: every
    device operation launched under ``nbody.step`` was launched under
    exactly one of its three children (so the step's own device time is 0),
    the force pass (the symmetric kernel and its fold) under
    ``nbody.forces``, and every step launches as many operations as the
    others."""
    import bisect
    import glob
    import gzip
    import json
    from parallel_nbody_tpu_torch.utils import timing
    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
    st = run(cfg, init_state(65536, cfg, device=dev), 1)
    torch.cuda.synchronize()
    d = str(tmp_path / "trace")
    with timing.trace(d):
        run(cfg, st, 20)
        torch.cuda.synchronize()
    (path,) = glob.glob(d + "/*.trace.json.gz")
    with gzip.open(path, "rt") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("nbody.")]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    steps = sorted((e["ts"], e["ts"] + e["dur"], e["tid"]) for e in spans
                   if e["name"] == "nbody.step")
    assert len(steps) == 20
    children = ("nbody.coincident", "nbody.forces", "nbody.integrate")
    per_step = [0] * len(steps)
    forces = {"block_forces_symmetric_kernel": 0, "band_fold_kernel": 0}
    for op in events:
        if op.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        launch = launches.get(op.get("args", {}).get("correlation"))
        if launch is None:
            continue
        t, tid = launch["ts"], launch["tid"]
        i = bisect.bisect_right([s[0] for s in steps], t) - 1
        if i < 0 or not (t < steps[i][1] and tid == steps[i][2]):
            continue
        per_step[i] += 1
        under = [e["name"] for e in spans if e["name"] in children
                 and e["tid"] == tid and e["ts"] <= t < e["ts"] + e["dur"]]
        assert len(under) == 1, (op["name"], under)
        for kernel in forces:
            if kernel in op["name"]:
                assert under == ["nbody.forces"]
                forces[kernel] += 1
    assert forces == {"block_forces_symmetric_kernel": 20,
                      "band_fold_kernel": 20}
    assert per_step[0] > 1 and len(set(per_step)) == 1, per_step


def test_diagnostics_on_card_match_cpu(dev):
    """validate_state, total_energy and run_trajectory on the card against
    the CPU in fp64 (dense fast forces: the same terms, summed in another
    order)."""
    from parallel_nbody_tpu_torch.models import engine
    from parallel_nbody_tpu_torch.utils.debug import validate_state
    cfg = SimConfig(force_mode="fast", dtype="float64")
    host, card = init_state(200, cfg), init_state(200, cfg, device=dev)
    fh, xh, yh = engine.run_trajectory(cfg, host, 12, 5)
    fc, xc, yc = engine.run_trajectory(cfg, card, 12, 5)
    assert xc.shape == (2, 200) and xc.device == dev
    np.testing.assert_allclose(xc.cpu().numpy(), xh.numpy(), rtol=1e-12)
    np.testing.assert_allclose(yc.cpu().numpy(), yh.numpy(), rtol=1e-12)
    np.testing.assert_allclose(float(engine.total_energy(cfg, fc)),
                               float(engine.total_energy(cfg, fh)),
                               rtol=1e-12)
    dh, dc = validate_state(fh, 1024, 768), validate_state(fc, 1024, 768)
    assert dc.ok() and dc.pos_in_bounds and dc.nan_fields == dh.nan_fields
    assert dc.max_speed == pytest.approx(dh.max_speed, rel=1e-12)
    assert dc.max_force == pytest.approx(dh.max_force, rel=1e-9)


# ---------------------------------------------------------------------------
# the distributed programs' path on one card
# ---------------------------------------------------------------------------

TAGGED_SEEDS = range(4)


def _tagged_input(seed, dev):
    """Own + visiting blocks as a ring hop sees them: 256 glibc-like bodies
    (coincident pairs with odd seeds), each body twice at seed 0 and 1 (a
    block visiting itself), a massless body on a massive one at seed 2."""
    x, y, m, _ = glibc_like(256, seed, ((3, 200),) if seed % 2 else ())
    x = x + np.random.RandomState(seed).uniform(0.1, 0.9, 256)
    if seed % 2:
        x[200] = x[3]
    gid = np.arange(256)
    if seed < 2:
        x, y, m, gid = (np.concatenate([a, a]) for a in (x, y, m, gid))
    if seed == 2:
        x[9], y[9], m[9] = x[4], y[4], 0.0
    return [torch.tensor(a, device=dev) for a in (x, y, m, gid)]


@pytest.mark.parametrize("seed", TAGGED_SEEDS)
def test_any_coincident_tagged_on_card(seed, dev):
    card = _tagged_input(seed, dev)
    flag = cuda_step.any_coincident_tagged(*card)
    assert flag.device == card[0].device and flag.dim() == 0
    assert bool(flag) == bool(cuda_step.any_coincident_tagged(
        *(t.cpu() for t in card))) == bool(seed % 2)


RANK_LAYOUTS = [("allgather", 2), ("allgather", 4), ("ring", 2), ("ring", 4),
                ("grid2d", 2, 2), ("grid2d", 1, 4), ("grid2d", 4, 1)]


def _plain_auto(cfg, xi, yi, mi, ri, xj, yj, mj, rj, **kw):
    plain = (cuda_step.block_forces_streamed_reference
             if max(xi.shape[0], xj.shape[0]) > cuda_step.STREAMED_ABOVE
             else cuda_step.block_forces_reference)
    return plain(cfg, xi, yi, mi, ri, xj, yj, mj, rj, **kw)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("layout", RANK_LAYOUTS,
                         ids=lambda l: "x".join(map(str, l[1:])) + "-" + l[0])
def test_rank_kernels_match_plain_versions(layout, dtype, dev, monkeypatch):
    """Every rank's force computation at N=4096 (glibc init, coincident
    pairs on and across rank boundaries) through K1 at the rank's offsets
    and rectangular shapes, against the same rank through K1's plain
    version on the card; each rank launches K1 once per call (the grid
    once per chunk)."""
    from parallel_nbody_tpu_torch.parallel import emulate, grid2d, sharded_step
    cfg = SimConfig(force_mode="fast", dtype=dtype, kernel="cuda")
    st = init_state(4096, cfg, device=dev)
    cuda_step.block_forces.launches = 0
    got = [prog() for prog in emulate.rank_programs(cfg, st, layout)]
    p = emulate.ranks(layout)
    calls = p * (layout[1] if layout[0] == "grid2d" else
                 p if layout[0] == "ring" else 1)
    assert cuda_step.block_forces.launches == calls
    for module in (sharded_step, grid2d):
        monkeypatch.setattr(module, "block_forces_auto", _plain_auto)
    want = [prog() for prog in emulate.rank_programs(cfg, st, layout)]
    for rank, (g, w) in enumerate(zip(got, want)):
        for gf, wf in zip(g, w):
            scale = float(wf.abs().max())
            err = float((gf - wf).abs().max())
            assert err <= TOL[dtype] * scale, (rank, err, scale)


@pytest.mark.parametrize("biased", [True, False])
def test_streamed_kernel_at_ring_offsets(biased, dev):
    """K2 on a ring hop's shapes: 1000 rows at row_g0=3000 against a
    visiting block of 3000 columns at col_g0=7000 (bands of 1024 with a
    ragged tail), fp32, against its plain version."""
    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
    st = init_state(10000, cfg, device=dev)
    full = (st.x, st.y, st.mass, st.radius)
    rows = [t[3000:4000].contiguous() for t in full]
    cols = [t[7000:10000].contiguous() for t in full]
    flag = torch.tensor(biased, device=dev)
    kw = dict(row_g0=3000, col_g0=7000, band=1024, biased=flag)
    got = cuda_step.block_forces_streamed(cfg, *rows, *cols, **kw)
    want = cuda_step.block_forces_streamed_reference(cfg, *rows, *cols, **kw)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= \
            TOL["float32"] * float(w.abs().max())


@pytest.fixture
def nccl_world_of_one(dev, tmp_path):
    """A process group of this process alone, on NCCL."""
    import torch.distributed as dist
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("program", ["allgather", "ring", "grid2d"])
def test_world_of_one_on_nccl_is_engine_run(program, dev, nccl_world_of_one):
    """World size 1: the same offsets and shapes as the single-device step,
    the tagged flag equal to any_coincident's, no ring hop, an all-reduce
    over one rank — bit-equal to engine.run, one K1 launch a step."""
    from parallel_nbody_tpu_torch.parallel.grid2d import (make_grid2d_run,
                                                          make_mesh2d)
    from parallel_nbody_tpu_torch.parallel.mesh import make_mesh
    from parallel_nbody_tpu_torch.parallel.sharded_step import \
        make_sharded_run
    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
    st = init_state(4096, cfg, device=dev)
    want = run(cfg, st, 5)
    if program == "grid2d":
        runner = make_grid2d_run(cfg, make_mesh2d(1, 1, "cuda"), 5)
    else:
        runner = make_sharded_run(cfg, make_mesh(1, "cuda"), 5, program)
    cuda_step.block_forces.launches = 0
    got = runner(st)
    assert cuda_step.block_forces.launches == 5
    for f, g, w in zip(got._fields, got, want):
        assert torch.equal(g, w), f


# ---------------------------------------------------------------------------
# the symmetric pass: K1's square fp32 case, each pair once
# ---------------------------------------------------------------------------

def _square(n, dev, dtype="float32"):
    """One block of bodies (x, y, mass, radius) on the card: the glibc init
    at n, which leaves coincident pairs at step 0."""
    st = init_state(n, SimConfig(dtype=dtype), device=dev)
    return (st.x, st.y, st.mass, st.radius)


def _counts():
    return (cuda_step.block_forces.launches,
            cuda_step.block_forces.symmetric_launches)


@pytest.mark.parametrize("biased", [True, False])
@pytest.mark.parametrize("n", [384, 4097, 65536, 131072])
def test_symmetric_kernel_matches_plain_version(n, biased, dev):
    """The symmetric pass against its plain version (the same tile pairs,
    diagonal tiles and fold order) within the kernels' bound; one force
    pass, taken by the symmetric kernel."""
    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
    b = _square(n, dev)
    flag = torch.tensor(biased, device=dev)
    before = _counts()
    got = cuda_step.block_forces(cfg, *b, *b, biased=flag)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1] + 1)
    want = cuda_step.block_forces_symmetric_reference(cfg, *b, biased=flag)
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= TOL["float32"] * scale


def test_symmetric_kernel_is_deterministic(dev):
    """No atomics: two passes on the same inputs give the same bits, as the
    benchmark's chunk_gap requires."""
    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    st = random_state(65536, cfg, gen, device=dev)
    b = (st.x, st.y, st.mass, st.radius)
    for biased in (True, False):
        one = cuda_step.block_forces(cfg, *b, *b, biased=biased)
        two = cuda_step.block_forces(cfg, *b, *b, biased=biased)
        assert all(torch.equal(g, w) for g, w in zip(one, two))


@pytest.mark.parametrize("case, symmetric", [
    ("fp32", True), ("bf16", True), ("fp64", False), ("compensated", False),
    ("off_diagonal", False)])
def test_symmetric_launches_count_square_fp32_plain_passes(case, symmetric,
                                                           dev):
    """symmetric_launches rises by one for a square fp32 or bf16 pass with
    plain sums, and not for fp64, compensated sums or an off-diagonal
    block, which stay bit-equal to the one-sided kernel
    (block_forces_one_sided, which counts nothing)."""
    dtype = {"bf16": "bfloat16", "fp64": "float64"}.get(case, "float32")
    cfg = SimConfig(force_mode="fast", dtype=dtype, kernel="cuda")
    b = _square(1000, dev, "float64" if case == "fp64" else "float32")
    if case == "bf16":
        b = tuple(t.to(torch.bfloat16) for t in b)
    kw = dict(biased=True, row_g0=0, col_g0=0, accum="plain")
    if case == "compensated":
        kw["accum"] = "compensated"
    if case == "off_diagonal":
        kw["col_g0"] = 128
    before = _counts()
    got = cuda_step.block_forces(cfg, *b, *b, **kw)
    assert _counts() == (before[0] + 1, before[1] + int(symmetric))
    if not symmetric:
        one_sided = cuda_step.block_forces_one_sided(cfg, *b, *b, **kw)
        assert _counts() == (before[0] + 1, before[1])
        assert all(torch.equal(g, w) for g, w in zip(got, one_sided))


def test_symmetric_workspace_fits_the_budget(dev):
    """At the top of K1's range (131072) the (tiles, 2, N) fp32 workspace
    stays within K2's budget of 1 GiB, and the pass allocates no more than
    it and its two outputs."""
    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
    n = cuda_step.STREAMED_ABOVE
    ws_bytes = -(-n // cuda_step.SYMMETRIC_TILE) * 2 * n * 4
    assert ws_bytes <= cuda_step.K2_WORKSPACE_BYTES
    b = _square(n, dev)
    cuda_step.block_forces(cfg, *b, *b, biased=False)  # warm the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    before = _counts()
    cuda_step.block_forces(cfg, *b, *b, biased=False)
    torch.cuda.synchronize()
    assert _counts()[1] == before[1] + 1
    assert torch.cuda.max_memory_allocated(dev) - base <= ws_bytes + 2 * n * 4


@pytest.mark.parametrize("name", sorted(KICK_PLACEMENTS))
def test_symmetric_kick_is_k1_kick_on_card(name, dev):
    """A coincident pair, every other body massless and far
    (state.pad_state's padding), the placement's rows against themselves:
    each body of the pair gets the one-sided kernel's kick bit for bit,
    with opposite signs, and the far bodies exactly 0."""
    rows, _, r0, _, (ia, ib) = kick_case(name)
    b = _on(rows, "float32", dev)
    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
    before = _counts()
    got = cuda_step.block_forces(cfg, *b, *b, row_g0=r0, col_g0=r0,
                                 biased=True)
    assert _counts()[1] == before[1] + 1
    want = cuda_step.block_forces_one_sided(cfg, *b, *b, row_g0=r0,
                                            col_g0=r0, biased=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    xf = got[0].cpu().numpy()
    np.testing.assert_allclose([xf[ia], xf[ib]], [KICK, -KICK], rtol=1e-6)
    far = np.ones(len(xf), bool)
    far[[ia, ib]] = False
    assert not xf[far].any() and not got[1].cpu().numpy().any()


# ---------------------------------------------------------------------------
# the speed tools on the card
# ---------------------------------------------------------------------------

def test_bench_headline_line_on_card(dev):
    """The benchmark's line on the card at a small size: the root
    bench.py's keys, a fingerprint of this card, K1 once a step."""
    from parallel_nbody_tpu_torch.benchmarks import bench
    cuda_step.block_forces.launches = 0
    line = bench.headline(dev, n=4096, steps=5, reps=2)
    assert cuda_step.block_forces.launches == 3 * 5
    assert set(line) == {"metric", "value", "unit", "vs_baseline",
                         "fingerprint"}
    assert line["value"] > 0 and "N=4096" in line["metric"]
    fp = line["fingerprint"]
    assert fp["device"] == "cuda"
    assert fp["name"] == torch.cuda.get_device_name(dev)
    assert fp["cuda"] == torch.version.cuda


def test_row_block_sabotage_is_bit_equal_on_card(dev, monkeypatch):
    """The perf gate's sabotage computes engine.run's state bit for bit,
    in N/R K1 launches a step (engine.run held to one-sided K1: its square
    fp32 pass is otherwise the symmetric one)."""
    from parallel_nbody_tpu_torch.benchmarks import bench
    cfg = bench.bench_cfg()
    gen = torch.Generator(device=dev).manual_seed(0)
    st = random_state(16384, cfg, gen, device=dev)
    cuda_step.block_forces.launches = 0
    got = bench.runner(cfg, 3, 4096)(st)
    assert cuda_step.block_forces.launches == 3 * 4
    monkeypatch.setattr(cuda_step, "takes_symmetric", lambda *a, **k: False)
    want = run(cfg, st, 3)
    for f, g, w in zip(got._fields, got, want):
        assert torch.equal(g, w), f


def test_row_block_sabotage_is_near_the_symmetric_main_path_on_card(dev):
    """The sabotage's row launches stay one-sided K1 (no symmetric pass),
    and its state lies within the kernels' 2e-6 * max|F| of engine.run's,
    whose square fp32 pass sums each pair once in another order."""
    from parallel_nbody_tpu_torch.benchmarks import bench
    cfg = bench.bench_cfg()
    gen = torch.Generator(device=dev).manual_seed(0)
    st = random_state(16384, cfg, gen, device=dev)
    before = _counts()
    got = bench.runner(cfg, 3, 4096)(st)
    assert _counts() == (before[0] + 3 * 4, before[1])
    want = run(cfg, st, 3)
    assert _counts()[1] == before[1] + 3
    for f, g, w in zip(got._fields, got, want):
        assert float((g - w).abs().max()) <= \
            TOL["float32"] * float(w.abs().max()), f


def test_k2_hold_on_card(dev):
    """The scaling grid's hold at the smallest N that runs K2: K2's first
    pass against its plain version on four misaligned row blocks."""
    from parallel_nbody_tpu_torch.benchmarks import run_benchmarks as rb
    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    st = random_state(262144, cfg, gen, device=dev)
    cuda_step.block_forces_streamed.launches = 0
    got = rb.hold_first_pass(cfg, st)
    assert cuda_step.block_forces_streamed.launches == 1
    assert got["ok"], got


# ---------------------------------------------------------------------------
# K1 in fp64 against the reference binary's committed outputs
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _replay_on_card(n, steps, oracle, tmp_path, capsys, monkeypatch,
                    flags=("--pallas",)):
    """One ``--dtype=float64`` CLI run on the card; returns (stdout split
    in lines, the oracle's lines, K1's launches: the warm-up step's and one
    a step under --pallas)."""
    arena = str(tmp_path / "replay.ppm")
    if not os.path.exists(arena):
        ppm.create(arena, 1024, 768)
    cuda_step.block_forces.launches = 0
    rc, out, err = _cli_on_card([str(n), "0", arena, str(steps),
                                 "--dtype=float64"] + list(flags), capsys,
                                monkeypatch)
    assert rc == 0, err
    with open(os.path.join(REPO, oracle)) as f:
        want = f.read()
    return out.splitlines(), want.splitlines(), cuda_step.block_forces.launches


@pytest.mark.parametrize("oracle, n, steps", [
    ("tests/fixtures/seq_2_1000.out", 2, 1000),
    ("tests_out/fuzz/seq_116_302.out", 116, 302),
    ("tests_out/fuzz_v2/seq_107_431.out", 107, 431),
])
def test_pallas_fp64_on_card_prints_reference_bytes(oracle, n, steps, dev,
                                                    tmp_path, capsys,
                                                    monkeypatch):
    """A few of chip_smoke.phase_reference_replay's runs: K1's fp64
    instantiation prints the reference binary's bytes."""
    got, want, launches = _replay_on_card(n, steps, oracle, tmp_path, capsys,
                                          monkeypatch)
    assert got == want
    assert launches == 1 + steps


def test_pallas_fp64_on_card_n10000_known_miss(dev, tmp_path, capsys,
                                               monkeypatch):
    """The one run of the replay where K1's fast formula misses the
    reference's bytes, pinned: body 8344's y-force at step 100 lies 4 ulps
    under a rounding boundary of its third decimal, and the fast formula in
    the TPU kernel's tile order rounds it down (chip_smoke's
    REPLAY_KNOWN_MISS; an open question)."""
    got, want, launches = _replay_on_card(
        10000, 100, "tests/fixtures/seq_10000_100.out", tmp_path, capsys,
        monkeypatch)
    assert launches == 101
    assert len(got) == len(want)
    diff = [(i + 1, a, b) for i, (a, b) in enumerate(zip(got, want))
            if a != b]
    assert diff in ([], [(
        8345,
        "   597.001    171.002 6725900.304 29213247.339      2.922      3.538",
        "   597.001    171.002 6725900.304 29213247.340      2.922      3.538")])


def test_dense_trig_on_card_prints_n10000_fixture(dev, tmp_path, capsys,
                                                  monkeypatch):
    """The port's parity path on the card (the dense trig decomposition, no
    K1) prints the N=10000 fixture that the fast formula misses by a digit.
    ~25 s (a 221 ms step)."""
    got, want, launches = _replay_on_card(
        10000, 100, "tests/fixtures/seq_10000_100.out", tmp_path, capsys,
        monkeypatch, flags=())
    assert got == want
    assert launches == 0


def test_pallas_fp64_resume_on_card_prints_reference_bytes(dev, tmp_path,
                                                           capsys,
                                                           monkeypatch):
    """A resume record of tests_out/fuzz_resume single-rank on the card: a
    .npz at step 1, resumed to 124, each leg equal to the reference's
    uninterrupted output at its step count."""
    ck = str(tmp_path / "replay.npz")
    d = "tests_out/fuzz_resume/"
    got, want, launches = _replay_on_card(
        114, 1, d + "seq_114_1.out", tmp_path, capsys, monkeypatch,
        ("--pallas", "--checkpoint=" + ck))
    assert (got, launches) == (want, 2)
    got, want, launches = _replay_on_card(
        114, 124, d + "seq_114_124.out", tmp_path, capsys, monkeypatch,
        ("--pallas", "--resume=" + ck))
    assert (got, launches) == (want, 124)


# ---------------------------------------------------------------------------
# The parity pass (csrc/forces_trig.cu): float64, the reference's trig pair
# math in its per-body order.  Held to the dense trig path on the card bit
# for bit: both compute each pair with the CUDA math library's atan2, cos
# and sin on the same arguments, round every other operation once, and add
# each body's terms in ascending partner order.
# ---------------------------------------------------------------------------

TRIG_CFG = SimConfig(force_mode="trig", dtype="float64", kernel="cuda")


def _trig_state(n, law, dev):
    """(x, y, mass, radius) on the card: the CLI's glibc init (coincident
    pairs from N=4096 on, and at N=2 the two bodies of ``trig_bodies``'s
    glibc law) or random_state."""
    if law == "glibc" and n >= 64:
        st = init_state(n, TRIG_CFG, device=dev)
        return [st.x, st.y, st.mass, st.radius]
    if law == "glibc":
        return _on(trig_bodies(n, "glibc"), "float64", dev)
    st = random_state(n, TRIG_CFG, torch.Generator(device=dev).manual_seed(n),
                      device=dev)
    return [st.x, st.y, st.mass, st.radius]


def _bit_equal(got, want):
    return all(torch.equal(g.view(torch.int64), w.view(torch.int64))
               for g, w in zip(got, want))


@pytest.mark.parametrize("law", ["glibc", "uniform"])
@pytest.mark.parametrize("n", [2, 64, 1000, 4096, 10000])
def test_trig_kernel_is_dense_trig_on_card(n, law, dev):
    from parallel_nbody_tpu_torch.ops.forces import compute_forces_dense
    b = _trig_state(n, law, dev)
    before = cuda_step.trig_forces.launches
    got = cuda_step.trig_forces(TRIG_CFG, *b)
    again = cuda_step.trig_forces(TRIG_CFG, *b)
    assert cuda_step.trig_forces.launches == before + 2
    want = compute_forces_dense(TRIG_CFG.replace(kernel="dense"), *b)
    assert _bit_equal(got, want)
    assert _bit_equal(again, got)


@pytest.mark.parametrize("n", [64, 4096, 65536])
def test_trig_kernel_is_its_plain_version_on_card(n, dev):
    """The plain version, run on the card's tensors, gives the kernel's
    bits (the wrapper takes it on CPU tensors only), also at the
    benchmark's N=65536, past the dense path's reach."""
    b = _trig_state(n, "glibc", dev)
    want = cuda_step.trig_forces_reference(TRIG_CFG, *b)
    assert _bit_equal(cuda_step.trig_forces(TRIG_CFG, *b), want)


def test_trig_engine_counts_one_pass_a_step_and_no_other_kernel(dev):
    """engine.run in the parity mode: one parity pass a step, no K1, K2 or
    symmetric pass; a fast-mode run launches K1's path and no parity pass."""
    st = init_state(4096, TRIG_CFG, device=dev)
    counts = lambda: (cuda_step.trig_forces.launches,  # noqa: E731
                      cuda_step.block_forces.launches,
                      cuda_step.block_forces_streamed.launches)
    t0, k10, k20 = counts()
    run(TRIG_CFG, st, 7)
    assert counts() == (t0 + 7, k10, k20)
    fast = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
    run(fast, init_state(4096, fast, device=dev), 3)
    assert counts() == (t0 + 7, k10 + 3, k20)


def test_trig_step_spans_on_card_hold_every_launch(dev, tmp_path):
    """11 steps at N=10000 under ``utils.timing.trace``, the first left out
    (the trace can miss the first device operation after the profiler
    starts, and this step's first is the parity kernel): every device
    operation launched under the other ``nbody.step`` spans lies under one
    of its children, ``nbody.forces`` or ``nbody.integrate`` (no
    ``nbody.coincident``: the trig formula makes the coincident kick
    itself), and the parity kernel, one a step, under ``nbody.forces``."""
    import glob
    import gzip
    import json
    from parallel_nbody_tpu_torch.utils import timing
    st = run(TRIG_CFG, init_state(10000, TRIG_CFG, device=dev), 1)
    torch.cuda.synchronize()
    d = str(tmp_path / "trace")
    with timing.trace(d):
        run(TRIG_CFG, st, 11)
        torch.cuda.synchronize()
    (path,) = glob.glob(d + "/*.trace.json.gz")
    with gzip.open(path, "rt") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("nbody.")]
    assert {e["name"] for e in spans} == {"nbody.step", "nbody.forces",
                                          "nbody.integrate"}
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    steps = sorted((e for e in spans if e["name"] == "nbody.step"),
                   key=lambda e: e["ts"])
    assert len(steps) == 11
    steps = steps[1:]
    trig, under_steps = 0, 0
    for op in events:
        if op.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        launch = launches.get(op.get("args", {}).get("correlation"))
        if launch is None:
            continue
        t, tid = launch["ts"], launch["tid"]
        if not any(s["ts"] <= t < s["ts"] + s["dur"] and s["tid"] == tid
                   for s in steps):
            continue
        under_steps += 1
        under = [e["name"] for e in spans if e["name"] != "nbody.step"
                 and e["tid"] == tid and e["ts"] <= t < e["ts"] + e["dur"]]
        assert len(under) == 1, (op["name"], under)
        if "trig_forces_kernel" in op["name"]:
            assert under == ["nbody.forces"]
            trig += 1
    assert trig == 10 and under_steps % 10 == 0


@pytest.mark.parametrize("oracle, n, steps", [
    ("tests/fixtures/seq_2_1000.out", 2, 1000),
    ("tests/fixtures/seq_256_300.out", 256, 300),
    ("tests_out/fuzz/seq_116_302.out", 116, 302),
    ("tests/fixtures/seq_10000_100.out", 10000, 100),
])
def test_trig_spelling_on_card_prints_reference_bytes(oracle, n, steps, dev,
                                                      tmp_path, capsys,
                                                      monkeypatch):
    """``--pallas --trig`` on the card prints the reference binary's bytes,
    the N=10000 fixture's line 8345 too, which K1's fast formula misses;
    the parity pass runs once a step and once for the warm-up step, and K1
    never."""
    cuda_step.trig_forces.launches = 0
    got, want, k1 = _replay_on_card(n, steps, oracle, tmp_path, capsys,
                                    monkeypatch, ("--pallas", "--trig"))
    assert got == want
    assert (k1, cuda_step.trig_forces.launches) == (0, 1 + steps)
