"""parallel_nbody_tpu_torch — the N-body engine on PyTorch and CUDA.

The port of ``parallel_nbody_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100.  Module names follow the JAX package, so each one's counterpart is
easy to find:

  - ``config`` / ``state``     — frozen physics config, SoA tensor state
  - ``ops``                    — dense forces, integration, and the
                                 hand-written CUDA force kernels
                                 (``ops.cuda_step``; ``csrc/forces.cu``,
                                 ``csrc/forces_streamed.cu``)
  - ``benchmarks``             — the probes of the kernels' pair loop
                                 (``csrc/roofline_probe.cu``,
                                 ``csrc/bias_variants_probe.cu``) and the
                                 SASS census of the pair loops
  - ``models.engine``          — the single-device step loop
  - ``utils``                  — glibc-rand parity init, PPM header, output
                                 contract, conversion from the JAX package
  - ``cli``                    — the reference's argv contract

This package never imports JAX.
"""

from .config import DELTA_T, FRICTION, GRAVITY, MAXBODIES, SEED, SimConfig
from .state import State, init_state, pad_state, random_state, unpad_state

__version__ = "0.1.0"

__all__ = [
    "SimConfig", "State", "init_state", "random_state", "pad_state",
    "unpad_state", "GRAVITY", "FRICTION", "DELTA_T", "MAXBODIES", "SEED",
]
