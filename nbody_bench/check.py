"""The comparison that decides ``correct``.

The dynamics are chaotic and the program runs in its configured precision,
so no reference can follow a whole window.  Each check therefore takes a
state the program itself produced (or the harness's own initial state),
recomputes in float64 what the program's step made of it, and measures the
program's answer against that:

- ``force_gap``: per body, the largest component gap of the forces divided
  by ``abs_force`` (the sum of the pair terms' magnitudes, which bounds
  what rounding a sum of them can do);
- ``velocity_gap``: per body and component, the gap of the new velocity
  divided by the magnitudes that enter it, ``|v| + (abs_force + FRICTION
  |v|) / m * dt``;
- ``position_gap``: per body and component, the gap of the new position
  divided by ``|x| + |v_new| * dt``;
- ``frame_pixels``: pixels whose colour differs from the reference's frame
  of the same state;
- ``chunk_gap``: elements of the state that differ between one call of
  ``engine.run`` over a whole chunk of the window and the same steps one
  call at a time, from the same state (exact: the window counts the steps
  it asks for, so a chunk that runs fewer, or returns its state, would
  inflate the rate).

A configuration may name ``check_rows``: the step checks then hold that
many bodies, drawn from the seed (``sample_rows``), against the float64
reference under all bodies, instead of every body.

Each is the largest over the bodies (or the count over the pixels).  A body
whose reference position lands within rounding of a wall (``WALL_ULPS``
units of the configured dtype) may take either branch of the bounce; it is
held to the branch nearer its answer.  Non-finite answers make every gap
NaN, which fails any limit.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

# Rounding units of the configured dtype within which a body's unclamped
# position may fall on either side of a wall.
WALL_ULPS = 8
_EPS = {"float64": 2.0 ** -53, "float32": 2.0 ** -24, "bfloat16": 2.0 ** -8}


def _axis_gaps(ans, ref, mass, abs_force, cfg, axis, dim):
    """(velocity gaps, position gaps) of one axis per body, each body held
    to the reference branch of the bounce nearer its answer when its
    unclamped position lies within rounding of a wall."""
    p, v = axis, axis + "v"
    prev_v, prev_x = ref["prev_" + v], ref["prev_" + p]
    vscale = prev_v.abs() + (abs_force + cfg["friction"] * ref["speed"]) \
        / mass * cfg["dt"]
    free = ref[p + "_free"]
    xscale = (prev_x.abs() + (free - prev_x).abs()).clamp(min=1e-300)

    def gaps(x_ref, v_ref):
        return ((ans[v] - v_ref).abs() / vscale,
                (ans[p] - x_ref).abs() / xscale)

    gv, gx = gaps(ref[p], ref[v])
    eps = _EPS[cfg["dtype"]]
    margin = WALL_ULPS * eps * (prev_x.abs() + (vscale + prev_v.abs())
                                * cfg["dt"])
    near_low = free.abs() <= margin
    near_high = (free - dim).abs() <= margin
    ambiguous = near_low | near_high
    if bool(ambiguous.any()):
        bounced = (free < 0) | (free >= dim)
        wall = torch.where(near_low, 0.0, float(dim - 1))
        alt_x = torch.where(bounced, free, wall)
        # The reference's new velocity before the bounce's negation.
        v_free = torch.where(bounced, -ref[v], ref[v])
        alt_v = torch.where(bounced, v_free, -v_free)
        av, ax = gaps(alt_x, alt_v)
        use_alt = ambiguous & (torch.maximum(av, ax) < torch.maximum(gv, gx))
        gv = torch.where(use_alt, av, gv)
        gx = torch.where(use_alt, ax, gx)
    return gv, gx


def _max(t) -> float:
    """Largest element, NaN if any element is NaN."""
    if bool(torch.isnan(t).any()):
        return float("nan")
    return float(t.max()) if t.numel() else 0.0


def reference_module(cfg):
    """The module of ``reference/`` that the configuration names."""
    return importlib.import_module("nbody_bench.reference."
                                   + cfg["reference"])


def sample_rows(n: int, seed: int, count=None):
    """The sorted indices of ``count`` bodies of ``n`` drawn from ``seed``
    (a CPU int64 tensor), or None for every body (``count`` None or at
    least ``n``)."""
    if count is None or count >= n:
        return None
    gen = torch.Generator().manual_seed(seed % (1 << 63) ^ 0x5EED)
    return torch.randperm(n, generator=gen)[:count].sort().values


def reference_step(prev, mass, radius, cfg, rows=None):
    """The step of the reference module that the configuration names
    (``cfg["reference"]``, a module of ``reference/``) from ``prev`` (dict
    of float64 tensors x, y, xv, yv), for the bodies ``rows`` (all when
    None), with what the gaps need of their previous state."""
    ref = reference_module(cfg).step(prev, mass, radius, cfg, rows)
    for k in ("x", "y", "xv", "yv"):
        ref["prev_" + k] = prev[k] if rows is None else prev[k][rows]
    ref["speed"] = torch.sqrt(ref["prev_xv"] ** 2 + ref["prev_yv"] ** 2)
    return ref


def step_gaps(ans, ref, mass, cfg) -> dict:
    """``force_gap``, ``velocity_gap`` and ``position_gap`` of the answer
    ``ans`` (dict of float64 tensors x, y, xv, yv, xf, yf on ``ref``'s
    device) against ``reference_step``'s ``ref``; ``ans`` and ``mass`` hold
    the bodies that ``ref`` holds."""
    a = ref["abs_force"]
    force = torch.maximum((ans["xf"] - ref["xf"]).abs(),
                          (ans["yf"] - ref["yf"]).abs()) / a
    gvx, gxx = _axis_gaps(ans, ref, mass, a, cfg, "x", cfg["xdim"])
    gvy, gxy = _axis_gaps(ans, ref, mass, a, cfg, "y", cfg["ydim"])
    return {"force_gap": _max(force),
            "velocity_gap": _max(torch.maximum(gvx, gvy)),
            "position_gap": _max(torch.maximum(gxx, gxy))}


def frame_pixels(frame: np.ndarray, ref_frame: np.ndarray) -> float:
    """Pixels whose colour differs (a wrong shape counts every pixel)."""
    if frame.shape != ref_frame.shape:
        return float(ref_frame.shape[0] * ref_frame.shape[1])
    return float(np.count_nonzero((frame != ref_frame).any(axis=-1)))


def state_gap(a, b, fields=("x", "y", "xv", "yv", "xf", "yf")) -> float:
    """Elements of the states ``a`` and ``b`` (objects with tensor fields
    of one device) that are not bit for bit alike; a NaN counts."""
    return float(sum(int((getattr(a, f) != getattr(b, f)).sum())
                     for f in fields))


def judge(readings: dict, limits: dict) -> dict:
    """``{name: {"value", "limit"}}`` for every reading; a reading
    ``<quantity>.<where>`` is held to ``limits[<quantity>]``."""
    out = {}
    for name, value in readings.items():
        limit = limits[name.split(".")[0]]
        out[name] = {"value": value, "limit": limit}
    return out


def passed(checks: dict) -> bool:
    """Every value at or under its limit (a NaN passes no limit)."""
    return all(c["value"] <= c["limit"] for c in checks.values())
