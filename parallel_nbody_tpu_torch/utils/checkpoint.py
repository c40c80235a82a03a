"""Checkpoint / resume: .npz state snapshots and sharded directories.

The reference has none — its only persistence is the final stdout dump.
The ``.npz`` is the JAX package's exact host snapshot: positions,
velocities, forces, masses, radii as float64 and the step counter as int64.
The layout is the JAX package's, so a file written by either package resumes
under the other.  The directory checkpoint (``save_state_dcp``) takes the
place of the JAX package's Orbax directory for sharded runs.
"""

from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch

from ..state import State


def save_state(path: str, state: State, step: int) -> None:
    arrays = {f: getattr(state, f).detach().to(
        device="cpu", dtype=torch.float64).numpy() for f in State._fields}
    np.savez(path, step=np.int64(step), **arrays)


def load_state(path: str, device: torch.device | str,
               dtype: torch.dtype) -> tuple[State, int]:
    """The snapshot's state on ``device`` in ``dtype`` (the run's, from its
    config), and its step counter."""
    with np.load(path) as z:
        state = State(*(torch.from_numpy(z[f]).to(device=device, dtype=dtype)
                        for f in State._fields))
        return state, int(z["step"])


# --- Directory checkpoints: sharded, on torch.distributed.checkpoint --------
#
# The .npz above is exact and simple (right at parity scale).  A directory
# checkpoint is written by every rank of a sharded run from its own shard,
# so no rank ever holds the full state for it; each field is a DTensor
# sharded along the body axis over the run's mesh.  It holds the JAX
# package's keys (``state``, ``step``, ``n_real``) but is not an Orbax
# directory: the .npz stays the file that either package's CLI resumes.

_DIR_KEYS = ("step", "n_real")


@contextlib.contextmanager
def _quiet_dcp():
    """torch.distributed.checkpoint warns that a save or load without a
    process group is a single-process one (here it is meant to be), and on
    every overwrite of a checkpoint directory (which this save does on
    purpose, as the .npz save overwrites its file)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", category=UserWarning,
                                message=".*assuming the intent is to")
        warnings.filterwarnings("ignore", category=UserWarning,
                                message=".*Detected an existing checkpoint")
        yield


def _placements(mesh):
    from torch.distributed.tensor import Shard
    return [Shard(0)] * mesh.ndim


def save_state_dcp(path: str, state: State, step: int,
                   n_real: int | None = None, mesh=None) -> None:
    """Write ``state`` (this rank's shard when ``mesh`` is given, else the
    whole state from one process) and its step counter into the directory
    ``path``.  ``n_real`` records the unpadded body count when ``state``
    carries sharding padding.  With ``mesh`` this is a collective: every
    rank of the mesh calls it.

    Only a directory is overwritten.  Anything else at ``path`` — a file,
    and also a symlink that points nowhere — is refused with the JAX
    package's message (its ``os.path.exists`` test lets a dangling symlink
    through; this one does not)."""
    import os

    import torch.distributed.checkpoint as dcp

    if os.path.lexists(path) and not os.path.isdir(path):
        raise ValueError(
            "refusing to replace existing non-directory file with a "
            "checkpoint directory (use a .npz suffix for a single-file "
            "snapshot)")
    if mesh is None:
        tensors = dict(state._asdict())
    else:
        from torch.distributed.tensor import DTensor
        tensors = {f: DTensor.from_local(t, mesh, _placements(mesh),
                                         run_check=False)
                   for f, t in state._asdict().items()}
    with _quiet_dcp():
        dcp.save({"state": tensors, "step": int(step),
                  "n_real": int(state.n if n_real is None else n_real)},
                 checkpoint_id=os.path.abspath(path), no_dist=mesh is None)


def dcp_metadata(path: str) -> dict:
    """The checkpoint's stored items (``"state.x"``, ..., ``"step"``,
    ``"n_real"``) with their metadata, nothing restored.  Raises
    ``ValueError`` when ``path`` is not a directory checkpoint of this
    package."""
    import os
    import pickle

    import torch.distributed.checkpoint as dcp

    try:
        meta = dcp.FileSystemReader(
            os.path.abspath(path)).read_metadata().state_dict_metadata
    except (OSError, EOFError, pickle.UnpicklingError) as e:
        raise ValueError("not a torch.distributed.checkpoint directory "
                         "(%s)" % e) from e
    want = ["state." + f for f in State._fields] + list(_DIR_KEYS)
    missing = [k for k in want if k not in meta]
    if missing:
        raise ValueError("not a state checkpoint: %s missing"
                         % ", ".join(missing))
    return meta


def dcp_saved_length(path: str, meta: dict | None = None) -> int:
    """Body-axis length of the stored arrays (padding included), from the
    metadata."""
    meta = dcp_metadata(path) if meta is None else meta
    return int(meta["state.x"].size[0])


def load_state_dcp(path: str, device, dtype: torch.dtype, mesh=None,
                   meta: dict | None = None) -> tuple[State, int, int]:
    """Restore a directory checkpoint -> (state, step, n_real), the state in
    ``dtype`` on ``device``.

    With ``mesh`` (whose size must divide the stored length) every rank
    reads only its own shard, straight into place — on a 1-D or a 2-D mesh
    alike — so resuming a sharded run never materializes the full state on
    one rank; a collective.  Without it each caller reads the whole stored
    state (padding included), on its own."""
    import os

    import torch.distributed.checkpoint as dcp

    meta = dcp_metadata(path) if meta is None else meta
    length = dcp_saved_length(path, meta)
    if mesh is None:
        tensors = {f: torch.empty(length, dtype=dtype, device=device)
                   for f in State._fields}
    else:
        from torch.distributed.tensor import DTensor
        if length % mesh.size():
            raise ValueError("%d stored bodies do not shard over %d ranks"
                             % (length, mesh.size()))
        shard = length // mesh.size()
        tensors = {f: DTensor.from_local(
            torch.empty(shard, dtype=dtype, device=device), mesh,
            _placements(mesh), run_check=False) for f in State._fields}
    tree = {"state": tensors, "step": 0, "n_real": 0}
    with _quiet_dcp():
        dcp.load(tree, checkpoint_id=os.path.abspath(path),
                 no_dist=mesh is None)
    state = State(*(t.to_local() if mesh is not None else t
                    for t in (tensors[f] for f in State._fields)))
    return state, int(tree["step"]), int(tree["n_real"])
