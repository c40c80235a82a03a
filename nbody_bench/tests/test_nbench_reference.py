"""The float64 reference against hand-worked cases and a naive loop."""

import math

import numpy as np
import pytest
import torch

from nbody_bench import check
from nbody_bench.reference import nbody_seq

CFG = dict(gravity=1.1, friction=0.01, dt=5e-6, xdim=1024, ydim=768,
           reference="nbody_seq", dtype="float32")


def t(*v):
    return torch.tensor(v, dtype=torch.float64)


def test_hand_worked_pair():
    # Distance 5 (3-4-5), radii 1 and 1.5: forced = max(25, 6.25) = 25.
    fx, fy, a = nbody_seq.forces(t(0, 3), t(0, 4), t(2, 8), t(1, 1.5), 1.1)
    f = 1.1 * 2 * 8 / 25
    assert fx.tolist() == pytest.approx([f * 0.6, -f * 0.6], rel=1e-15)
    assert fy.tolist() == pytest.approx([f * 0.8, -f * 0.8], rel=1e-15)
    assert a.tolist() == pytest.approx([f, f], rel=1e-15)


def test_softened_pair():
    # Distance 1 under radii 1 and 1: forced = (1 + 1)^2 = 4, along +y.
    fx, fy, _ = nbody_seq.forces(t(7, 7), t(2, 3), t(1, 3), t(1, 1), 1.1)
    assert fx.tolist() == [0.0, 0.0]
    assert fy.tolist() == pytest.approx([1.1 * 3 / 4, -1.1 * 3 / 4])


def test_coincident_pair_kick():
    # atan2(0, 0) = 0: the lower index is pushed +x, the higher -x; a third
    # body away from both adds its ordinary pull.
    x, y = t(5, 5, 5), t(5, 5, 9)
    m, r = t(2, 3, 0.0), t(1, 2, 1)
    fx, fy, a = nbody_seq.forces(x, y, m, r, 1.1)
    kick = 1.1 * 2 * 3 / 9
    assert fx.tolist() == pytest.approx([kick, -kick, 0.0])
    assert fy.tolist() == pytest.approx([0.0, 0.0, 0.0])
    assert a[0] == pytest.approx(kick)


def _naive(x, y, m, r, g):
    n = len(x)
    fx, fy = np.zeros(n), np.zeros(n)
    for i in range(n):
        for j in range(i + 1, n):
            dx, dy = x[j] - x[i], y[j] - y[i]
            ang = math.atan2(dy, dx)
            d2 = dx * dx + dy * dy
            force = m[i] * m[j] * g / max(d2, (r[i] + r[j]) ** 2)
            fx[i] += force * math.cos(ang)
            fy[i] += force * math.sin(ang)
            fx[j] -= force * math.cos(ang)
            fy[j] -= force * math.sin(ang)
    return fx, fy


@pytest.mark.parametrize("block", [1 << 25, 7 * 40])
def test_against_the_reference_loop(monkeypatch, block):
    monkeypatch.setattr(nbody_seq, "BLOCK_ELEMS", block)
    rng = np.random.default_rng(3)
    x = rng.integers(0, 8, 40).astype(float)
    y = rng.integers(0, 8, 40).astype(float)
    m, r = rng.uniform(1, 9, 40), rng.uniform(1, 2, 40)
    ex, ey = _naive(x, y, m, r, 1.1)
    fx, fy, _ = nbody_seq.forces(*(torch.from_numpy(v) for v in (x, y, m, r)),
                                 1.1)
    assert np.allclose(fx.numpy(), ex, rtol=1e-12, atol=1e-12)
    assert np.allclose(fy.numpy(), ey, rtol=1e-12, atol=1e-12)
    rows = torch.tensor([3, 17, 39])
    sub = nbody_seq.forces(*(torch.from_numpy(v) for v in (x, y, m, r)), 1.1,
                           rows=rows)
    assert torch.equal(sub[0], fx[rows])


def test_velocity_and_bounce():
    st = dict(x=t(0.0, 1023.99999), y=t(10, 10), xv=t(-4, 4), yv=t(0, 0))
    out = nbody_seq.step(st, t(1, 1), t(1, 1), CFG)
    # Friction along the velocity, then v += f / m * dt (forces tiny here).
    v0 = -4 + (out["xf"][0] + 0.04) * 5e-6
    assert out["xv"][0] == pytest.approx(-v0, rel=1e-12)  # bounced at 0
    assert out["x"][0] == 0.0
    assert out["x"][1] == 1023.0 and out["xv"][1] < 0  # bounced at xdim - 1
    assert out["x_free"][1] >= 1024.0


def test_step_of_sampled_rows_is_the_whole_steps_rows():
    rng = np.random.default_rng(5)
    st = {k: torch.from_numpy(rng.uniform(1, 700, 50))
          for k in ("x", "y")}
    st.update({k: torch.from_numpy(rng.uniform(-5, 5, 50))
               for k in ("xv", "yv")})
    m, r = (torch.from_numpy(rng.uniform(1, 2, 50)) for _ in range(2))
    whole = nbody_seq.step(st, m, r, CFG)
    rows = check.sample_rows(50, 2**31 + 77, 12)
    part = nbody_seq.step(st, m, r, CFG, rows)
    for k, v in part.items():
        assert torch.equal(v, whole[k][rows]), k
    ref = check.reference_step(st, m, r, CFG, rows)
    assert torch.equal(ref["prev_xv"], st["xv"][rows])


def test_sample_rows_from_the_seed():
    a = check.sample_rows(1000, 2**31 + 5, 64)
    assert torch.equal(a, check.sample_rows(1000, 2**31 + 5, 64))
    assert not torch.equal(a, check.sample_rows(1000, 2**31 + 6, 64))
    assert a.shape == (64,) and torch.equal(a, a.unique())
    assert check.sample_rows(1000, 1, None) is None
    assert check.sample_rows(1000, 1, 1000) is None


def test_frame_first_hit_and_tint():
    # Body 1 overlaps body 0: shared pixels take the lower index.
    x, y, r = t(4, 5, 30, 20), t(4, 4, 2, 4), t(1, 1, 0.2, 1.5)
    img = nbody_seq.frame(x, y, r, 32, 8).numpy()
    n = 4
    tint = [(0xFFF * (b + 1)) // (n + 2) for b in range(n)]
    rgb = [[(v & 0xF) << 4, v & 0xF0, (v & 0xF00) >> 4] for v in tint]
    assert img[4, 4].tolist() == rgb[0]
    assert img[4, 5].tolist() == rgb[0]  # both hit: body 0 wins
    assert img[4, 6].tolist() == rgb[1]
    assert img[2, 30].tolist() == rgb[2]
    assert img[0, 0].tolist() == [0, 0, 0]
    # A hit is sqrt(dx^2 + dy^2) <= radius + 0.5, the edge included.
    assert img[4, 22].tolist() == rgb[3] and img[4, 23].tolist() == [0, 0, 0]
    assert img[6, 20].tolist() == rgb[3] and img[7, 20].tolist() == [0, 0, 0]
