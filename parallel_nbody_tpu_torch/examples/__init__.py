"""Examples of the port, runnable as modules:

    python -m parallel_nbody_tpu_torch.examples.animate [N] [steps] \\
        [record_every] [outdir] [--device=cpu|cuda]
"""
