"""The port's tools for the card: probes of the force kernels' pair loop,
the accuracy tools, and the speed tooling.

Counterparts of the JAX package's ``benchmarks/`` scripts (and its root
``bench.py``), each run with ``python -m
parallel_nbody_tpu_torch.benchmarks.<name>``:

- the probes ``roofline_probe`` (P1) and ``bias_variants_probe`` (P2),
  built on hand-written CUDA kernels (``csrc/roofline_probe.cu``,
  ``csrc/bias_variants_probe.cu``), with ``sass_census`` counting the pair
  loops' instructions;
- the accuracy tools ``hw_validate`` (the gate against float64) and
  ``drift_study``;
- the speed tooling ``bench`` (the headline), ``perf_gate``,
  ``run_benchmarks`` (the scaling grid), ``ring_bias_probe``,
  ``bf16_stream_probe``, ``autotune`` and ``huge_n``.

Every tool measures on the card and exits 1 without one; the accuracy and
speed tools run on the CPU only where ``--device=cpu`` asks for it, at
small sizes, and their records name the device they ran on.
"""
