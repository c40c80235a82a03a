"""The distributed programs on ``torch.distributed``: one rank is one process
with one device (gloo on the CPU, NCCL on CUDA cards).

  - ``mesh``          — rank meshes, the state's shards on them, and the
                        collectives the programs use
  - ``sharded_step``  — the 1-D body decomposition: all-gather and ring
  - ``grid2d``        — the 2-D force-matrix decomposition
  - ``multihost``     — launchers: torchrun, the manual spelling of the JAX
                        package's scripts, and ranks spawned by one command
  - ``emulate``       — every rank's force computation called in one process
  - ``dryrun``        — K gloo ranks on the CPU held to the single-rank run

Each rank's force computation is a plain function of the tensors it is
given; the collectives live only in the run loops.
"""
