"""Tests of the CUDA kernel on the card (marker ``gpu``; they skip without
one).  This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

Tolerances: the kernel against its plain version on the same card is held
to 1e-5 * max|F| in fp32 (the kernel sums each row sequentially; at these
sizes the difference is below 1e-6 * max|F|) and 1e-12 * max|F| in fp64.
"""

import numpy as np
import pytest
import torch

from parallel_nbody_tpu_torch import cli
from parallel_nbody_tpu_torch.config import SimConfig
from parallel_nbody_tpu_torch.models.engine import run
from parallel_nbody_tpu_torch.ops import cuda_step
from parallel_nbody_tpu_torch.state import init_state
from parallel_nbody_tpu_torch.utils import ppm
from torch_cases import BLOCK_CASES, KICK, blocks

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
