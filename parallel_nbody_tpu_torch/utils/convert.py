"""Carry a state and a configuration across from the JAX package.

The counterpart of carrying weights across: a JAX ``State._asdict()`` (after
``np.asarray`` on each field) becomes a port ``State``, and
``dataclasses.asdict`` of a JAX ``SimConfig`` becomes a port ``SimConfig``.
Only numpy arrays and plain values cross, so nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..config import SimConfig
from ..state import State

# JAX-side knobs with no counterpart here: the Pallas tile sizes and the
# Pallas interpret-mode switch.
_TPU_ONLY_FIELDS = ("tile_i", "tile_j", "pallas_interpret")


def state_from_numpy(fields: Mapping[str, np.ndarray], *,
                     dtype: torch.dtype,
                     device: torch.device | str = "cpu") -> State:
    """Build a ``State`` from a mapping with exactly the ``State`` field
    names (x, y, xv, yv, xf, yf, mass, radius)."""
    if set(fields) != set(State._fields):
        raise ValueError("expected fields %s, got %s"
                         % (sorted(State._fields), sorted(fields)))
    return State(*(torch.from_numpy(np.array(fields[f])).to(
        device=device, dtype=dtype) for f in State._fields))


def config_from_dict(d: Mapping[str, Any]) -> SimConfig:
    """Build a ``SimConfig`` from ``dataclasses.asdict`` of the JAX one."""
    return SimConfig(**{k: v for k, v in d.items()
                        if k not in _TPU_ONLY_FIELDS})
