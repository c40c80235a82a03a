"""The port's probes of the force kernels' pair loop on the card.

Counterparts of the JAX package's ``benchmarks/roofline_probe.py`` (P1) and
``benchmarks/bias_variants_probe.py`` (P2), with the same argv and output
lines, built on hand-written CUDA kernels (``csrc/roofline_probe.cu``,
``csrc/bias_variants_probe.cu``):

    python -m parallel_nbody_tpu_torch.benchmarks.roofline_probe [N] [steps]
    python -m parallel_nbody_tpu_torch.benchmarks.bias_variants_probe \\
        [N] [steps] [tile_i] [tile_j]

Both measure only on a CUDA card and exit 1 without one.
"""
