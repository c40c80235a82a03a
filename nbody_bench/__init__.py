"""The benchmark of ``parallel_nbody_tpu_torch`` on one NVIDIA H100.

``python3 -m nbody_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line.  Everything that belongs to one configuration, traffic mix, metric or
cell is a file of its own, found by the name the manifest gives it:
``configs/<config>.json``, ``traffic/<mix>.json``, ``metrics/<metric>.py``
and ``limits/<cell>.json``.  The plain float64 reference that decides
``correct`` is ``reference/``; it imports nothing of the port.
"""
