"""Performance regression gate over the port's headline benchmark.

The counterpart of the JAX package's ``benchmarks/perf_gate.py``: it runs
``python -m parallel_nbody_tpu_torch.benchmarks.bench`` (or reads a
recorded JSON line) and FAILS — exit 1 and a loud ``PERF GATE:
REGRESSION`` — when the N=65536 fused fp32 rate on the card falls below the
floor.

Floor: ``FLOOR_PAIRS_PER_S``, about 8% under the port's recorded H100
headline (``perf_gate.json``'s PASS run; PERF.md §6), not the TPU's
9.5e10: wide enough for the spread of best-of-5 runs, tight enough that a
slower kernel or step cannot ship silently.

    python -m parallel_nbody_tpu_torch.benchmarks.perf_gate           # bench, then gate
    python -m parallel_nbody_tpu_torch.benchmarks.perf_gate --json=PATH
    python -m parallel_nbody_tpu_torch.benchmarks.perf_gate --floor=X
    python -m parallel_nbody_tpu_torch.benchmarks.perf_gate --out=PATH
    python -m parallel_nbody_tpu_torch.benchmarks.perf_gate --record=PATH

The floor is pinned to the headline size: a line whose metric is not the
N=65536 benchmark (a ``--device=cpu`` bench line, N=4096) gates as
NO_FLOOR, as in the JAX gate.  Without a card the benchmark exits 1, so
``run_bench`` reports ERROR and the gate exits 1: no line from the CPU
passes unless it is handed over with ``--json``.

Sabotage: ``NBODY_BENCH_ROWS=8192`` makes the benchmark cut each force
pass into eight K1 launches of 8192 rows (``bench.py``): the same forces
from launches that fill half the card, far below the floor.
``--record=PATH`` runs the gate, then the sabotage, and writes both runs
(``pass`` and ``sabotage``, with ``bench_rows``) to PATH: the committed
``perf_gate.json``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

from ._tools import REPO
from .bench import ROWS_ENV

# About 8% under the port's headline on one H100 80GB HBM3 at 700 W:
# 7.597e11-7.607e11 pairs/s in three runs of the benchmark (PERF.md §6).
FLOOR_PAIRS_PER_S = 7.0e11
HEADLINE_N = 65536
SABOTAGE_ROWS = 8192


def evaluate(payload: dict, floor: float = FLOOR_PAIRS_PER_S) -> dict:
    """Gate one bench JSON payload -> record dict with a 'status' key.

    Statuses: PASS (headline config at/above floor), REGRESSION (below),
    NO_FLOOR (not the headline config — e.g. the CPU's size), ERROR (the
    benchmark itself failed).  Only REGRESSION and ERROR are failures.
    """
    if "error" in payload:
        return {"status": "ERROR", "error": payload["error"]}
    metric = str(payload.get("metric", ""))
    m = re.search(r"N=(\d+)", metric)
    n = int(m.group(1)) if m else None
    rate = float(payload["value"])
    if n != HEADLINE_N:
        return {"status": "NO_FLOOR", "n": n, "rate": rate,
                "note": "floor is pinned to the N=%d headline config"
                        % HEADLINE_N}
    status = "PASS" if rate >= floor else "REGRESSION"
    return {"status": status, "n": n, "rate": rate, "floor": floor,
            "headroom": round(rate / floor, 4)}


def run_bench(env=None) -> dict:
    """Run the port's benchmark and parse its JSON line."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    proc = subprocess.run(
        [sys.executable, "-m", "parallel_nbody_tpu_torch.benchmarks.bench"],
        capture_output=True, text=True, cwd=REPO, env=env)
    lines = [l for l in proc.stdout.strip().splitlines() if l.strip()]
    if proc.returncode != 0 or not lines:
        return {"error": "bench rc=%d: %s"
                         % (proc.returncode, (proc.stderr or "")[-500:])}
    return json.loads(lines[-1])


def load_recorded(path: str) -> dict:
    """Load a recorded bench payload: either a raw bench line (possibly
    with log noise above it) or a recorded BENCH_r*.json (whose
    'parsed' key holds the bench line)."""
    with open(path) as f:
        text = f.read().strip()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = json.loads(text.splitlines()[-1])
    if isinstance(doc, dict) and "parsed" in doc:
        return doc["parsed"]
    return doc


def gate(payload: dict, floor: float) -> dict:
    record = evaluate(payload, floor)
    record["bench"] = payload
    return record


def record_both(floor: float, rows: int = SABOTAGE_ROWS) -> dict:
    """The gate on the benchmark, then on the sabotaged benchmark (the
    force pass in launches of ``rows`` rows): the committed record's
    shape."""
    passed = gate(run_bench(), floor)
    sabotage = gate(run_bench(dict(os.environ, **{ROWS_ENV: str(rows)})),
                    floor)
    sabotage["bench_rows"] = rows
    return {"pass": passed, "sabotage": sabotage,
            "note": "the sabotage cuts each force pass into K1 launches of "
                    "%d rows (%s=%d)" % (rows, ROWS_ENV, rows),
            "when": time.strftime("%Y-%m-%d %H:%M:%S")}


def _print(record: dict) -> str:
    status = record["status"]
    detail = {k: v for k, v in record.items() if k not in ("status", "bench")}
    print("PERF GATE: %s %s" % (status, json.dumps(detail)))
    return status


def main(argv) -> int:
    floor = FLOOR_PAIRS_PER_S
    json_path = out_path = record_path = None
    for a in argv:
        if a.startswith("--floor="):
            floor = float(a.split("=", 1)[1])
        elif a.startswith("--json="):
            json_path = a.split("=", 1)[1]
        elif a.startswith("--out="):
            out_path = a.split("=", 1)[1]
        elif a.startswith("--record="):
            record_path = a.split("=", 1)[1]
        else:
            sys.stderr.write("unknown argument: %s\n" % a)
            return 2

    if record_path:
        both = record_both(floor)
        with open(record_path, "w") as f:
            json.dump(both, f, indent=1)
            f.write("\n")
        statuses = [_print(both[run]) for run in ("pass", "sabotage")]
        ok = statuses == ["PASS", "REGRESSION"]
        print("PERF GATE RECORD: %s" % ("OK" if ok else "FAILED"))
        return 0 if ok else 1

    record = gate(load_recorded(json_path) if json_path else run_bench(),
                  floor)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
    status = _print(record)
    return 1 if status in ("REGRESSION", "ERROR") else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
