"""Simulation configuration.

The reference hard-codes its physics constants as C preprocessor defines
(nbody/nbody-seq.c:22-27).  Here they live in a frozen dataclass, with the
same constants and validation as ``parallel_nbody_tpu.config``.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

# Reference constants (nbody/nbody-seq.c:22-27).  BOUNCE=-0.9 is defined in the
# reference but never used — the wall bounce is a plain velocity negation.
GRAVITY = 1.1
FRICTION = 0.01
MAXBODIES = 10000
DELTA_T = 0.025 / 5000
SEED = 27102015

ForceMode = Literal["trig", "fast"]

# The JAX package's kernel names, accepted as aliases.
_KERNEL_ALIASES = {"xla": "dense", "pallas": "cuda"}


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation parameters.

    Attributes:
      xdim, ydim: arena dimensions (taken from the P6 PPM header in the
        reference, nbody/nbody-seq.c:431).
      gravity / friction / dt: physics constants.
      force_mode: ``"trig"`` reproduces the reference's transcendental force
        decomposition ``force * cos(atan2(dy, dx))`` (nbody/nbody-seq.c:
        91-98) — required for golden-output parity.  ``"fast"`` uses the
        algebraically equal ``force * dx * rsqrt(dsqr)``.
      dtype: element type of the state tensors ("bfloat16", "float32" or
        "float64").  Parity runs use float64.
      kernel: ``"dense"`` materializes the (N, N) pair matrix with plain
        tensor ops; ``"cuda"`` runs the hand-written all-pairs kernels
        (csrc/, ops/cuda_step.py).  ``"xla"`` and ``"pallas"`` (the JAX
        package's names) map to them.  With ``"cuda"``, bfloat16 is a
        storage format: the kernels compute and sum in float32.
      accum: ``"plain"`` sums force partials directly; ``"compensated"``
        Kahan-folds the CUDA kernels' partial sums (per column tile, and
        across column bands above 131072 bodies).  The dense path ignores
        it, as the JAX package's does.
    """

    xdim: int = 1024
    ydim: int = 768
    gravity: float = GRAVITY
    friction: float = FRICTION
    dt: float = DELTA_T
    force_mode: ForceMode = "trig"
    dtype: str = "float64"
    kernel: Literal["dense", "cuda"] = "dense"
    accum: Literal["plain", "compensated"] = "plain"

    def __post_init__(self):
        object.__setattr__(self, "kernel",
                           _KERNEL_ALIASES.get(self.kernel, self.kernel))
        if self.kernel not in ("dense", "cuda"):
            raise ValueError("unsupported kernel %r (expected dense or cuda)"
                             % (self.kernel,))
        if self.kernel == "cuda" and self.force_mode == "trig":
            raise ValueError(
                "kernel='cuda' implements only force_mode='fast' (the "
                "transcendental-free path); the trig parity decomposition "
                "(nbody-seq.c:91-98) requires kernel='dense'")
        if self.dtype == "float16":
            raise ValueError(
                "dtype='float16' is unsupported: the reference mass law "
                "mass = radius^3 (nbody-seq.c:444-447) exceeds float16's "
                "65504 max for any N >= 8 at the default arena, and the "
                "force kernel's mass_i*mass_j product overflows it at every "
                "N — use 'bfloat16' for 16-bit runs")
        if self.dtype not in ("bfloat16", "float32", "float64"):
            raise ValueError(
                "unsupported dtype %r (expected bfloat16, float32 or "
                "float64)" % (self.dtype,))
        if self.accum not in ("plain", "compensated"):
            raise ValueError("unsupported accum %r (expected plain or "
                             "compensated)" % (self.accum,))

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)
