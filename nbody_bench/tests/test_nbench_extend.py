"""A cell, a configuration, a traffic mix and a metric are added by new
files and new manifest entries alone: a dummy of each, in a copy, runs."""

import json
import os
import shutil

import torch

from conftest import MANIFEST, ROOT

from nbody_bench import harness


def test_dummy_entries_run(tmp_path):
    bench = tmp_path / "bench"
    for kind in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(ROOT, "nbody_bench", kind),
                        bench / kind)
    with open(MANIFEST) as f:
        manifest = json.load(f)
    with open(os.path.join(ROOT, "nbody_bench/configs/k1_fp32_64k.json")) \
            as f:
        conf = json.load(f)
    # The new files.
    conf.update(n=300, chunk_steps=3)
    (bench / "configs" / "dummy_cfg.json").write_text(json.dumps(conf))
    (bench / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {"init": "uniform", "frame_every": 2}))
    (bench / "limits" / "dummy_cell.json").write_text(
        (bench / "limits" / "k1_64k_frames.json").read_text())
    (bench / "metrics" / "dummy_steps.py").write_text(
        "def read(run):\n    return float(run.window.steps)\n")
    # The new entries.
    manifest["configs"].append(
        {"name": "dummy_cfg", "source": "https://example.org/dummy",
         "file": "bench/configs/dummy_cfg.json", "reduced": [],
         "why": "a dummy"})
    manifest["workloads"].append(
        {"name": "dummy_cell", "config": "dummy_cfg",
         "traffic": "dummy_mix", "chips": 1, "why": "a dummy"})
    manifest["end_to_end"].append(
        {"name": "dummy_steps", "unit": "steps", "better": "higher",
         "bound": 0.1, "source": "host_clock", "workloads": ["dummy_cell"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(manifest))

    cell = harness.load_cell(str(path), "dummy_cell")
    out = harness.run(cell, 2**31 + 9, 0.3, False, torch.device("cpu"))
    assert out["correct"], out["checks"]
    assert out["metrics"]["dummy_steps"]["value"] > 0
    # The metrics without a ``workloads`` key, and the new one.
    assert set(out["metrics"]) == {"setup_s", "dummy_steps"}
    assert "frame_pixels.frame" in out["checks"]
