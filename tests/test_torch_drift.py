"""Long-run drift of the port against fp64 and against the JAX package
(the counterpart of tests/test_energy_drift.py, BASELINE config 3).

The fp32 fast path must track the fp64 trig path over a long run, stay
finite at scale, and keep the energy bounded (friction dissipates).  Each
test also runs the JAX package on the same state, carried across with
``utils/convert``, and holds the port's trajectory to it.
"""

import numpy as np
import pytest
import torch

from parallel_nbody_tpu.config import SimConfig as JaxConfig
from parallel_nbody_tpu.models import engine as jengine
from parallel_nbody_tpu.state import init_state as jax_init_state
from parallel_nbody_tpu.state import random_state as jax_random_state
from parallel_nbody_tpu_torch.config import SimConfig
from parallel_nbody_tpu_torch.models.engine import run, total_energy
from parallel_nbody_tpu_torch.utils.convert import state_from_numpy

torch.set_num_threads(1)

F64 = SimConfig(force_mode="trig", dtype="float64")
F32 = SimConfig(force_mode="fast", dtype="float32")
JF64 = JaxConfig(force_mode="trig", dtype="float64")
JF32 = JaxConfig(force_mode="fast", dtype="float32")
FIELDS = ("x", "y", "xv", "yv", "xf", "yf")


def _carry(jstate, dtype):
    return state_from_numpy({f: np.array(v)
                             for f, v in jstate._asdict().items()},
                            dtype=dtype)


def _tracks(got, want, rel):
    """Every field of ``got`` within ``rel`` times the field's max of the
    JAX package's ``want``."""
    for f in FIELDS:
        w = np.asarray(getattr(want, f), np.float64)
        np.testing.assert_allclose(
            getattr(got, f).double().numpy(), w, rtol=0,
            atol=rel * np.abs(w).max(), err_msg=f)


def test_fp32_tracks_fp64_positions():
    """N=256, 500 steps: fp32 fast within 0.05 px of fp64 trig (measured
    0.0123).  Against the JAX package on the same initial states: fp64
    trig within 1e-12 of each field's max (the printed state is byte-equal
    to the fixtures; measured: positions equal, forces 1e-15 of their
    max), fp32 fast within 1e-5 (fp32 force sums in another order; measured:
    positions equal, velocities 5e-7)."""
    n, steps = 256, 500
    j64 = jax_init_state(n, JF64)
    j32 = jax_init_state(n, JF32)
    out64 = run(F64, _carry(j64, torch.float64), steps)
    out32 = run(F32, _carry(j32, torch.float32), steps)
    dx = (out32.x.double() - out64.x).abs().max()
    dy = (out32.y.double() - out64.y).abs().max()
    assert dx < 0.05, dx
    assert dy < 0.05, dy
    _tracks(out64, jengine.run(JF64, j64, steps), 1e-12)
    _tracks(out32, jengine.run(JF32, j32, steps), 1e-5)


@pytest.mark.slow
def test_no_nans_at_scale_fp32():
    """random_state(4096) of the JAX package, 100 fp32 steps (~140 s on one
    CPU thread): every field finite, and within 1e-5 of each field's max
    of the JAX run (measured: positions 2.3e-10 px apart)."""
    import jax
    jst = jax_random_state(4096, JF32, jax.random.PRNGKey(7))
    out = run(F32, _carry(jst, torch.float32), 100)
    for name, t in zip(out._fields, out):
        assert bool(torch.isfinite(t).all()), name
    _tracks(out, jengine.run(JF32, jst, 100), 1e-5)


@pytest.mark.slow
def test_energy_bounded_long_run_fp32():
    """N=512, 5000 fp32 steps: the energy stays finite and grows by no more
    than 5% of |E0| (friction dissipates), and the trajectory stays within
    1e-4 of each field's max of the JAX run."""
    n, steps = 512, 5000
    jst = jax_init_state(n, JF32)
    st = _carry(jst, torch.float32)
    e0 = float(total_energy(F32, st))
    out = run(F32, st, steps)
    e1 = float(total_energy(F32, out))
    assert np.isfinite(e1)
    assert e1 <= e0 + 0.05 * abs(e0)
    _tracks(out, jengine.run(JF32, jst, steps), 1e-4)
