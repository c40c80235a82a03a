"""The port's speed tooling against the JAX package's: the headline
benchmark (``benchmarks/bench``), the perf gate (``benchmarks/perf_gate``),
the scaling grid (``benchmarks/run_benchmarks``), the K2 probes
(``ring_bias_probe``, ``bf16_stream_probe``, ``autotune``) and the N=10M
step (``huge_n``), on the CPU at small sizes.  The JAX package's tools
(``bench.py``, ``benchmarks/*.py``) are loaded by path; none is run on a
device.  No tool may run without a card unless the CPU is asked for.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_nbody_tpu.config import SimConfig as JaxConfig
from parallel_nbody_tpu.models import engine as jengine
from parallel_nbody_tpu.state import State as JaxState
from parallel_nbody_tpu_torch.benchmarks import (autotune, bench,
                                                 bf16_stream_probe, huge_n,
                                                 kernel_ab, perf_gate,
                                                 ring_bias_probe,
                                                 run_benchmarks)
from parallel_nbody_tpu_torch.config import SimConfig
from parallel_nbody_tpu_torch.ops import cuda_step
from parallel_nbody_tpu_torch.state import random_state
from parallel_nbody_tpu_torch.utils.output import pair_interactions

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _load(relpath, name):
    """A JAX-side script of the repo, imported by path."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_gate():
    return _load("benchmarks/perf_gate.py", "jax_perf_gate")


def _line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


# ---------------------------------------------------------------------------
# bench
# ---------------------------------------------------------------------------

def test_bench_line_has_the_root_keys_and_counts_pairs_alike(monkeypatch,
                                                              capsys):
    """The root bench.py's four keys plus ``fingerprint``; the rate is
    ``n * (n - 1) // 2 * steps`` over the best time (root bench.py:147-150),
    with the timer replaced so the arithmetic is exact."""
    monkeypatch.setattr(bench, "CPU_N", 256)
    monkeypatch.setattr(bench, "CPU_STEPS", 3)
    monkeypatch.setattr(bench, "REPS", 2)
    monkeypatch.setattr(bench, "wall", lambda fn, device: (0.5, fn()))
    monkeypatch.delenv(bench.ROWS_ENV, raising=False)
    assert bench.main(["bench", "--device=cpu"]) == 0
    line = _line(capsys)
    assert set(line) == {"metric", "value", "unit", "vs_baseline",
                         "fingerprint"}
    n, steps = 256, 3
    rate = n * (n - 1) // 2 * steps / 0.5
    assert pair_interactions(n, steps) == n * (n - 1) // 2 * steps
    assert line["value"] == round(rate, 1)
    assert line["vs_baseline"] == round(rate / 4.45e8, 2)
    assert line["unit"] == "pairs/s"
    assert "N=256" in line["metric"] and "CPU" in line["metric"]
    assert line["fingerprint"]["device"] == "cpu"
    assert line["fingerprint"]["name"].startswith("cpu")


def test_bench_rows_cut_the_force_pass_into_row_blocks(monkeypatch,
                                                      capsys):
    """The sabotage knob: every step's force pass is N/R calls of
    ``block_forces_auto`` over R rows at their offsets, and the state is
    bit-equal to engine.run's (the same rows against the same columns)."""
    calls = []
    real = bench.block_forces_auto

    def counting(cfg, xi, *a, **kw):
        calls.append((xi.shape[0], kw["row_g0"]))
        return real(cfg, xi, *a, **kw)

    monkeypatch.setattr(bench, "block_forces_auto", counting)
    cfg = bench.bench_cfg()
    st = random_state(256, cfg, torch.Generator().manual_seed(0))
    got = bench.runner(cfg, 2, 64)(st)
    assert calls == [(64, r0) for r0 in (0, 64, 128, 192)] * 2
    want = bench.runner(cfg, 2, None)(st)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    monkeypatch.setenv(bench.ROWS_ENV, "128")
    monkeypatch.setattr(bench, "CPU_N", 256)
    monkeypatch.setattr(bench, "CPU_STEPS", 2)
    monkeypatch.setattr(bench, "REPS", 1)
    calls.clear()
    assert bench.main(["bench", "--device=cpu"]) == 0
    assert calls == [(128, 0), (128, 128)] * 4  # warm-up and one timed run
    assert "K1 in launches of 128 rows" in _line(capsys)["metric"]


# ---------------------------------------------------------------------------
# perf gate
# ---------------------------------------------------------------------------

def _payload(n, value):
    return {"metric": "pairwise interactions/s/chip (N=%d, fused fp32 CUDA "
                      "step, K1)" % n,
            "value": value, "unit": "pairs/s", "vs_baseline": 1.0}


@pytest.mark.parametrize("payload, status", [
    (_payload(65536, 7.0e11), "PASS"),
    (_payload(65536, 6.0e11), "REGRESSION"),
    (_payload(4096, 2.4e7), "NO_FLOOR"),
    ({"error": "bench rc=1: no CUDA device"}, "ERROR"),
])
def test_evaluate_matches_the_jax_gate(payload, status, jax_gate):
    floor = 6.5e11
    got = perf_gate.evaluate(payload, floor)
    assert got == jax_gate.evaluate(payload, floor)
    assert got["status"] == status


def test_floor_is_below_the_recorded_headline():
    with open(os.path.join(os.path.dirname(perf_gate.__file__),
                           "perf_gate.json")) as f:
        rec = json.load(f)
    rate = rec["pass"]["rate"]
    assert 0.9 * rate <= perf_gate.FLOOR_PAIRS_PER_S < rate
    assert rec["pass"]["floor"] == perf_gate.FLOOR_PAIRS_PER_S


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_load_recorded_reads_the_bench_records(k, jax_gate):
    path = os.path.join(REPO, "BENCH_r0%d.json" % k)
    got = perf_gate.load_recorded(path)
    assert got == jax_gate.load_recorded(path)
    # The TPU's rates against the TPU's floor; the port's floor is the
    # card's, far above them.
    assert perf_gate.evaluate(got, jax_gate.FLOOR_PAIRS_PER_S) == \
        jax_gate.evaluate(got)
    assert jax_gate.evaluate(got)["status"] == "PASS"
    assert perf_gate.evaluate(got)["status"] == "REGRESSION"


def test_load_recorded_takes_the_last_line(tmp_path):
    p = tmp_path / "bench.log"
    p.write_text("log noise\n" + json.dumps(_payload(65536, 7.0e11)) + "\n")
    assert perf_gate.load_recorded(str(p))["value"] == 7.0e11


def _gate(tmp_path, payload, *extra):
    p = tmp_path / "bench.json"
    p.write_text(json.dumps(payload) + "\n")
    out = tmp_path / "gate.json"
    rc = perf_gate.main(["--json=%s" % p, "--out=%s" % out] + list(extra))
    return rc, json.loads(out.read_text())


def test_gate_cli_passes_trips_and_takes_a_floor(tmp_path, capsys):
    floor = perf_gate.FLOOR_PAIRS_PER_S
    rc, rec = _gate(tmp_path, _payload(65536, floor * 1.05))
    assert rc == 0 and rec["status"] == "PASS"
    assert "PERF GATE: PASS" in capsys.readouterr().out
    rc, rec = _gate(tmp_path, _payload(65536, floor * 0.7))
    assert rc == 1 and rec["status"] == "REGRESSION"
    assert "PERF GATE: REGRESSION" in capsys.readouterr().out
    rc, _ = _gate(tmp_path, _payload(65536, floor * 0.7),
                  "--floor=%r" % (floor * 0.6))
    assert rc == 0
    assert perf_gate.main(["--bogus"]) == 2


def test_record_holds_the_pass_and_the_sabotage(tmp_path, monkeypatch,
                                                capsys):
    """``--record``: the gate's run, then the run with NBODY_BENCH_ROWS set,
    both in one file; it succeeds only if the first passes and the second
    trips."""
    seen = []

    def fake_run_bench(env=None):
        rows = (env or {}).get(bench.ROWS_ENV)
        seen.append(rows)
        return _payload(65536, 4e11 if rows else 8e11)

    monkeypatch.setattr(perf_gate, "run_bench", fake_run_bench)
    path = tmp_path / "perf_gate.json"
    assert perf_gate.main(["--record=%s" % path]) == 0
    assert seen == [None, str(perf_gate.SABOTAGE_ROWS)]
    rec = json.loads(path.read_text())
    assert rec["pass"]["status"] == "PASS"
    assert rec["sabotage"]["status"] == "REGRESSION"
    assert rec["sabotage"]["bench_rows"] == perf_gate.SABOTAGE_ROWS
    assert "PERF GATE RECORD: OK" in capsys.readouterr().out


def test_committed_gate_record_is_an_h100_pass_with_a_sabotage_trip():
    """As tests/test_perf_gate.py:106 checks the JAX record: the port's
    committed perf_gate.json holds a PASS at the headline on the card and a
    sabotage run that tripped the gate."""
    with open(os.path.join(os.path.dirname(perf_gate.__file__),
                           "perf_gate.json")) as f:
        rec = json.load(f)
    for run in ("pass", "sabotage"):
        fp = rec[run]["bench"]["fingerprint"]
        assert fp["device"] == "cuda" and "H100" in fp["name"]
        assert "N=65536" in rec[run]["bench"]["metric"]
    assert rec["pass"]["status"] == "PASS"
    assert rec["pass"]["rate"] >= rec["pass"]["floor"]
    assert rec["sabotage"]["status"] == "REGRESSION"
    assert rec["sabotage"]["rate"] < rec["sabotage"]["floor"]
    assert rec["sabotage"]["bench_rows"] > 0


def test_gate_without_a_card_is_an_error():
    """Here there is no card: the benchmark exits 1, and the gate reports
    ERROR and exits 1 (no CPU line passes through ``run_bench``)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "parallel_nbody_tpu_torch.benchmarks"
         ".perf_gate"], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=300)
    assert r.returncode == 1
    assert "PERF GATE: ERROR" in r.stdout
    assert "no CUDA device is available" in r.stdout


# ---------------------------------------------------------------------------
# no card, no CPU asked for
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tool", [bench, run_benchmarks, ring_bias_probe,
                                  bf16_stream_probe, autotune, huge_n],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_tools_exit_1_without_a_card(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(["tool"]) == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert "no CUDA device is available" in out.err
    assert tool.main(["tool", "--device=tpu"]) == 1
    assert "unsupported device" in capsys.readouterr().err


def test_kernel_ab_exits_1_without_a_card(monkeypatch, capsys):
    """The parent-against-change timer has no CPU mode at all."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_ab.main(["kernel_ab", "change"]) == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert "no CUDA device is available" in out.err


def test_bench_module_exits_1_without_a_card():
    """As a command (``python -m``), on this CPU-only host."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "parallel_nbody_tpu_torch.benchmarks.bench"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 1 and r.stdout == ""
    assert "bench: no CUDA device is available" in r.stderr


# ---------------------------------------------------------------------------
# --device=cpu runs, each naming the CPU
# ---------------------------------------------------------------------------

def test_run_benchmarks_quick_cpu_matches_the_jax_report(tmp_path):
    """``--quick --device=cpu``: the JAX tool's seq_grid (sizes 512 and
    1024, 10 steps, run_benchmarks.py:64-80) with its keys; no grid of the
    card's kernels; the shard grid over two gloo ranks."""
    out = tmp_path / "results.json"
    assert run_benchmarks.main(["run_benchmarks", "--quick", "--device=cpu",
                                "--out=%s" % out]) == 0
    rep = json.loads(out.read_text())
    assert rep["backend"] == "cpu" and rep["fingerprint"]["device"] == "cpu"
    assert list(rep["seq_grid"]) == ["512", "1024"]
    for row in rep["seq_grid"].values():
        assert set(row) == {"steps", "rtime_s", "gflops", "pairs_per_s"}
        assert row["steps"] == 10 and row["pairs_per_s"] > 0
    assert "cuda_grid" not in rep
    assert set(rep["shard_grid"]) == {"allgather", "ring"}
    for row in rep["shard_grid"].values():
        assert set(row) == {"n", "devices", "steps", "rtime_s",
                            "pairs_per_s"}
        assert row["devices"] == 2 and row["rtime_s"] > 0


def test_grid_steps_are_the_jax_tools():
    """run_benchmarks.py:95: k = max(3, min(200, int(2e11 // (n*n//2))))."""
    for n in run_benchmarks.GRID_SIZES:
        assert run_benchmarks.grid_steps(n) == max(
            3, min(200, int(2e11 // (n * n // 2))))
    assert [run_benchmarks.grid_steps(n) for n in (1 << 20, 1 << 21)] == \
        [3, 3]


@pytest.mark.parametrize("wrong", [False, True])
def test_hold_compares_the_first_pass_with_the_plain_version(wrong,
                                                             monkeypatch):
    """The row-sample hold at a small size: four blocks at offsets that are
    not multiples of 128 agree with K2's plain version; a force pass with
    one row wrong fails it."""
    monkeypatch.setattr(run_benchmarks, "HOLD_BLOCK", 200)
    monkeypatch.setattr(run_benchmarks, "HOLD_ROWS", 800)
    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="cuda")
    st = random_state(2048, cfg, torch.Generator().manual_seed(0))
    if wrong:
        real = cuda_step.cuda_forces

        def off_by_one_row(*a, **kw):
            fx, fy = real(*a, **kw)
            fx = fx.clone()
            fx[2048 // 3 + 40] += fx.abs().max()
            return fx, fy

        monkeypatch.setattr(run_benchmarks, "cuda_forces", off_by_one_row)
    got = run_benchmarks.hold_first_pass(cfg, st)
    assert all(r % 128 for r in got["row_starts"])
    assert got["ok"] is not wrong
    if not wrong:
        assert got["rel_to_max"] < run_benchmarks.HOLD_TOL


def test_probes_on_the_cpu_write_records_that_name_it(tmp_path):
    for tool, name in ((ring_bias_probe, "ring"), (bf16_stream_probe, "bf16"),
                       (autotune, "autotune")):
        out = tmp_path / ("%s.json" % name)
        assert tool.main([name, "--device=cpu", "--out=%s" % out]) == 0
        rec = json.loads(out.read_text())
        assert rec["fingerprint"]["device"] == "cpu"
        assert rec["fingerprint"]["name"].startswith("cpu")
    ring = json.loads((tmp_path / "ring.json").read_text())
    for case in ring["cases"].values():
        assert set(case) >= {"biased", "unbiased", "bias_cost_pct"}
    bf16 = json.loads((tmp_path / "bf16.json").read_text())
    assert set(bf16["modes"]) == {"float32", "bfloat16"}
    tune = json.loads((tmp_path / "autotune.json").read_text())
    assert {r["kernel"] for r in tune["threshold"]} == {"K1", "K2"}
    assert all(r["band"] for r in tune["band"])


def test_no_default_record_from_a_cpu_run(monkeypatch, tmp_path):
    """A CPU run writes a record only where --out says; a card run without
    --out writes beside the tool."""
    from parallel_nbody_tpu_torch.benchmarks import _tools
    assert _tools.record_path({}, CPU, "ring_bias.json") is None
    assert _tools.record_path({"out": "x.json"}, CPU, "r.json") == "x.json"
    assert _tools.record_path({}, torch.device("cuda"), "r.json") == \
        os.path.join(_tools.HERE, "r.json")


# ---------------------------------------------------------------------------
# huge_n: one step against the JAX package's engine.step
# ---------------------------------------------------------------------------

def test_huge_n_step_matches_jax_engine_step(tmp_path):
    """N=4096 in fp32 on the CPU: huge_n's step (``huge_step``: the
    seeded ``random_state`` and one step of ``make_hosted_row_step``, K2's
    plain version in one row chunk at this size, one band, which sums as
    K1's does) against JAX ``engine.step`` with the Pallas kernel in
    interpret mode, on the same state carried across as numpy.  The two
    sum each row in other tiles (128 columns against Pallas's 1024) and
    agree to ~1e-7 of max|F| (tests/test_torch_ops.py): forces within 1e-5
    of their max, positions and velocities within rtol 1e-6 (the step
    moves a body by ~dt * v, far below that)."""
    n = 4096
    cfg = huge_n.huge_cfg()
    st = random_state(n, cfg, torch.Generator().manual_seed(huge_n.SEED))
    _, got = huge_n.huge_step(torch.device("cpu"), n,
                              str(tmp_path / "frame.ppm"), log=lambda s: None)
    jcfg = JaxConfig(force_mode="fast", dtype="float32", kernel="pallas",
                     pallas_interpret=True)
    want = jengine.step(jcfg, JaxState(**{
        f: jnp.asarray(getattr(st, f).numpy()) for f in st._fields}))
    for f in ("x", "y", "xv", "yv"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    for f in ("xf", "yf"):
        w = np.asarray(getattr(want, f))
        np.testing.assert_allclose(getattr(got, f).numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=f)


def test_huge_n_on_the_cpu_writes_a_frame_and_a_record(tmp_path):
    ppm_path = tmp_path / "frame.ppm"
    out = tmp_path / "huge.json"
    assert huge_n.main(["huge_n", "512", "128", str(ppm_path),
                        "--device=cpu", "--out=%s" % out]) == 0
    rec = json.loads(out.read_text())
    assert set(rec) >= {"n", "init_s", "step_s", "one_sided_pairs_per_s",
                        "unordered_pairs_per_s", "render_s"}
    assert rec["n"] == 512 and rec["lit_pixels"] > 0
    assert rec["row_chunk"] == 128 and rec["chunks"] == 4
    assert rec["fingerprint"]["device"] == "cpu"
    assert ppm_path.stat().st_size > 1024 * 768 * 3
