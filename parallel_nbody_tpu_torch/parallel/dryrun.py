"""Multi-rank dry run on the CPU: the JAX package's ``dryrun.py`` and
``multihost_smoke.py`` in one module, since in PyTorch a rank is always a
process.

    python -m parallel_nbody_tpu_torch.parallel.dryrun K [steps]

spawns K gloo ranks on the CPU (``multihost.spawn``) and runs, on every
rank, the real distributed programs over N = 16K + 5 bodies (not a multiple
of K, so padding is exercised):

  - fp64 trig through the all-gather and ring programs, and through the
    2-D grid that K allows (2 x K/2 for even K >= 4, else 1 x K): the
    gathered printout must be byte-equal to the single-rank run over the
    same initial state — the reference's NP-grid contract (every
    partitioning reproduces the sequential oracle, bin/run-tests.sh);
  - the kernel path (``kernel="cuda"``, whose plain versions run on CPU
    tensors) through all-gather and ring, against its own single-rank run
    over the padded state within rtol 1e-9, atol 1e-6 (fp64; the ranks'
    offsets move the coincident bias's tile segments, as in the JAX
    package's multihost_smoke).

Rank 0 prints one line and ``MULTIHOST_OK``; a divergence raises on the
rank, and the command exits 1 with its traceback.
"""

from __future__ import annotations

import sys

STEPS = 3


def _grid_shape(k: int) -> tuple[int, int]:
    return (2, k // 2) if k % 2 == 0 and k >= 4 else (1, k)


def _rank(device, k: int, steps: int) -> int:
    import numpy as np

    from ..config import SimConfig
    from ..models.engine import run
    from ..state import init_state, pad_state, unpad_state
    from ..utils.output import format_state
    from .grid2d import make_grid2d_run, make_mesh2d
    from .mesh import gather_state, make_mesh, shard_state
    from .sharded_step import make_sharded_run

    cfg = SimConfig(force_mode="trig", dtype="float64")
    n = 16 * k + 5
    state = init_state(n, cfg)
    expected = format_state(run(cfg, state, steps))
    padded, n_real = pad_state(state, k)
    mesh = make_mesh(k, device.type)
    pr, pc = _grid_shape(k)
    mesh2d = make_mesh2d(pr, pc, device.type)
    runs = [("comm=" + comm, mesh, make_sharded_run(cfg, mesh, steps, comm))
            for comm in ("allgather", "ring")]
    runs.append(("grid2d(%dx%d)" % (pr, pc), mesh2d,
                 make_grid2d_run(cfg, mesh2d, steps)))
    for label, m, runner in runs:
        out = gather_state(runner(shard_state(padded, m, device)))
        if format_state(unpad_state(out, n_real)) != expected:
            raise RuntimeError("%s over %d ranks diverged from the "
                               "single-rank run" % (label, k))

    cfg_k = SimConfig(force_mode="fast", dtype="float64", kernel="cuda")
    want = run(cfg_k, padded, steps)
    for comm in ("allgather", "ring"):
        runner = make_sharded_run(cfg_k, mesh, steps, comm)
        got = gather_state(runner(shard_state(padded, mesh, device)))
        for field, g, w in zip(want._fields, got, want):
            np.testing.assert_allclose(
                g.cpu().numpy(), w.cpu().numpy(), rtol=1e-9, atol=1e-6,
                err_msg="kernel path comm=%s, field %s" % (comm, field))
    if mesh.get_rank() == 0:
        print("dryrun ok: %d ranks (gloo), comm=allgather+ring+grid2d(%dx%d)"
              "+kernel(allgather+ring), %d bodies, %d steps, output matches "
              "the single-rank run" % (k, pr, pc, n, steps))
        print("MULTIHOST_OK")
    return 0


def main(argv=None) -> int:
    from .multihost import spawn

    argv = sys.argv if argv is None else argv
    k = int(argv[1]) if len(argv) > 1 else 2
    steps = int(argv[2]) if len(argv) > 2 else STEPS
    return spawn(_rank, k, "cpu", args=(k, steps))


if __name__ == "__main__":
    sys.exit(main())
