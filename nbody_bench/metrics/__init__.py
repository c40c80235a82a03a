"""Metric readers, one file per metric: ``metrics/<name>.py`` defines
``read(run)``, which returns the metric's value from a ``harness.Run``, or
None when the run holds nothing to read (the harness then leaves the metric
out of the line).  The harness finds a reader by the metric's name in
``BENCHMARK.json``, so a metric is added by adding its file."""

from __future__ import annotations

import importlib.util
import json
import os

_DIR = os.path.dirname(os.path.abspath(__file__))
_PEAKS = os.path.join(os.path.dirname(_DIR), "peaks.json")


def read(name: str, run, directory: str = _DIR):
    """The value of metric ``name`` for ``run`` (None: nothing to read)."""
    path = os.path.join(directory, name + ".py")
    spec = importlib.util.spec_from_file_location("nbody_bench_metric_"
                                                  + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(run)


def peaks(kind: str):
    """The published peaks of the card named ``kind``
    (``torch.cuda.get_device_name``), or None for a card not in the
    table."""
    with open(_PEAKS) as f:
        return json.load(f).get(kind)


def pairs(n: int) -> int:
    """Unordered pairs of ``n`` bodies, the rate's unit (the reference's
    pair loop, nbody-seq.c:79-109)."""
    return n * (n - 1) // 2


def nr_flops(n: int) -> int:
    """The reference's FLOP model of one step (``nr_flops``,
    nbody-seq.c:367-380): 20 per unordered pair, 18 + 4 per body."""
    return 20 * pairs(n) + 18 * n + 4 * n
