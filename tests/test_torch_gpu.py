"""Tests of the CUDA kernels on the card (marker ``gpu``; they skip without
one).  This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

Tolerances: each kernel (K1 ``block_forces``, K2 ``block_forces_streamed``)
against its plain version on the same card is held to 1e-5 * max|F| in fp32
(the kernels sum each row sequentially; at these sizes the difference is
below 1e-6 * max|F|) and 1e-12 * max|F| in fp64.  The magnitude-spread case
keeps the bounds of tests/test_accum.py; bf16 launches are bit-equal to the
fp32 launch on the upcast inputs rounded once.  The probe kernels (P1, P2)
at N=4096: 2e-5 * max|F| for the fp32 variants (chip_smoke.TOL), and for
the two tensor-core variants, which round each term to tf32 (2^-11
relative), the per-row bound |err_i| <= 2^-10 * |G m_i| * sum_j |term_ij|.
"""

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
from parallel_nbody_tpu_torch.state import init_state
from parallel_nbody_tpu_torch.utils import ppm
from torch_cases import (BLOCK_CASES, KICK, KICK_PLACEMENTS, SEGMENT_CASES,
                         blocks, glibc_like, kick_case, probe_inputs,
                         segment_blocks)

TOL = {"float32": 1e-5, "float64": 1e-12}

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
    """(arrays on the card, tiles) for one probe input at N=4096."""
    if case == "independent":
        return _on(probe_inputs(4096, 30), "float32", dev), {}
    if case == "square_coincident":
        return (_on(probe_inputs(4096, 31, square=True), "float32", dev),
                dict(tile_i=128, tile_j=256))
    raise ValueError(case)


def _assert_probe_close(module, variant, got, args, tiles):
    *want, xmag, ymag = module.probe_forces_reference(
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
                                  "fed_back"])
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


@pytest.mark.parametrize("probe", sorted(PROBES))
def test_probe_forces_launches_on_card_never_plain(probe, dev, monkeypatch):
    module = PROBES[probe]

    def plain(*a, **kw):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(_probe, "reference", plain)
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
