"""The frozen init laws against glibc and against the port's own init."""

import numpy as np
import pytest
import torch

from nbody_bench.inputs import glibc, make, radius_mass

GLIBC = {"init": "glibc"}
UNIFORM = {"init": "uniform"}
from parallel_nbody_tpu_torch.config import SimConfig
from parallel_nbody_tpu_torch.state import init_state, random_state


def test_glibc_known_outputs():
    # glibc: srand(1); rand() x 3.
    assert glibc.rand_stream(1, 3).tolist() == [1804289383, 846930886,
                                                1681692777]


@pytest.mark.parametrize("seed", [27102015, 1, 2**31 + 12345, 2**32 + 7])
def test_glibc_matches_the_ports_init(seed):
    cfg = SimConfig()
    ours = make(GLIBC, 257, cfg.xdim, cfg.ydim, seed)
    port = init_state(257, cfg, seed=seed & 0xFFFFFFFF)
    for a, name in zip(ours, ("x", "y", "xv", "yv", "mass", "radius")):
        assert np.array_equal(a, getattr(port, name).numpy()), name


def test_glibc_positions_are_whole_pixels_with_coincident_pairs():
    x, y, *_ = make(GLIBC, 4096, 1024, 768, 5)
    assert np.array_equal(x, np.floor(x)) and x.max() < 1024
    assert len(set(zip(x, y))) < 4096


def test_uniform_is_the_random_state_law_and_repeats():
    a = make(UNIFORM, 1000, 1024, 768, 2**31 + 3)
    b = make(UNIFORM, 1000, 1024, 768, 2**31 + 3)
    assert all(np.array_equal(p, q) for p, q in zip(a, b))
    x, y, xv, yv, mass, radius = a
    assert 0 <= x.min() and x.max() < 1024 and 0 <= y.min() and y.max() < 768
    assert -5 <= xv.min() and xv.max() < 5 and -5 <= yv.min() and yv.max() < 5
    assert len(set(zip(x, y))) == 1000
    port = random_state(1000, SimConfig(),
                        torch.Generator().manual_seed(0))
    assert np.allclose(radius, port.radius.numpy(), rtol=1e-12)
    assert np.allclose(mass, port.mass.numpy(), rtol=1e-12)


def test_radius_mass_law():
    mass, radius = radius_mass(3, 1024, 768)
    assert radius[0] == 1.0 + 1280.0 / (25.0 * 10.0)
    assert np.allclose(mass, radius ** 3, rtol=0)


def test_relabel_keeps_the_bodies_and_draws_the_order_from_the_seed():
    mix = {"init": "glibc", "law_seed": 27102015, "relabel": True}
    base = make(GLIBC, 500, 1024, 768, 27102015)
    a = make(mix, 500, 1024, 768, 2**31 + 1)
    b = make(mix, 500, 1024, 768, 2**31 + 2)
    key = lambda arrs: sorted(zip(*arrs))  # noqa: E731
    assert key(a) == key(base) == key(b)
    assert not np.array_equal(a[0], b[0])
    assert all(np.array_equal(p, q) for p, q in
               zip(a, make(mix, 500, 1024, 768, 2**31 + 1)))
