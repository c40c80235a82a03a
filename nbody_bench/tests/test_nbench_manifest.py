"""BENCHMARK.json against the benchmark's contract: keys, names, units,
files, and that every metric, configuration, mix and cell has its file."""

import json
import os
import re

import pytest

from conftest import MANIFEST, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection)|_dim$"
                   r"|_rank$|head|expansion|per_tok")
BENCH = os.path.join(ROOT, "nbody_bench")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(MANIFEST) <= 64 * 1024
    assert manifest["command"] == ["python3", "-m", "nbody_bench.run"]
    assert manifest["paths"] == ["nbody_bench"]
    assert all(_line(w) for w in manifest["command"])


def test_run_seconds_fits_the_full_check(manifest):
    t = manifest["run_seconds"]
    assert isinstance(t, int) and 1 <= t <= 51
    # 24 cells: 2 + 14 * 24 runs of t + 60 s, 2 * 90 s a cell to compile,
    # 1200 s spare, within 43200 s.
    assert (2 + 14 * 24) * (t + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entry_keys(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("nbody_bench/configs/")
        assert c["reduced"] == []
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
        names.append(w["name"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and NAME.match(m["name"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])


def test_issue_names(manifest):
    assert [w["name"] for w in manifest["workloads"]] == [
        "k1_64k_glibc", "k2_1m_uniform", "k1_64k_frames", "k1_64k_uniform"]
    assert {c["name"] for c in manifest["configs"]} == {"k1_fp32_64k",
                                                        "k2_fp32_1m"}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert set(e2e) == {"pairs_per_s", "pairs_per_s.k2",
                        "pairs_per_s.frames", "frame_interval_ms_p90",
                        "setup_s"}
    assert e2e["setup_s"]["bound"] == 0.25
    layers = {"enqueue_us_per_step", "force_ms", "force_roofline_pct",
              "coincident_ms", "integrate_ms", "step_mfu", "device_idle_pct"}
    assert {m["name"] for m in manifest["per_layer"]} >= layers | {
        k + ".k2" for k in layers} | {"render_ms", "frame_host_ms",
                                      "device_idle_pct.frames"}
    units = {m["name"]: m["unit"] for m in manifest["end_to_end"]
             + manifest["per_layer"]}
    assert units["pairs_per_s"] == units["pairs_per_s.frames"] == \
        units["pairs_per_s.k2"] == "pairs/s"
    assert units["force_roofline_pct"] == units["force_roofline_pct.k2"] \
        == "%"


def test_each_rate_has_its_own_cells(manifest):
    """Every cell reports exactly one rate, and a rate's per-layer metrics
    list the cells of that rate."""
    rates = [m for m in manifest["end_to_end"]
             if m["name"].startswith("pairs_per_s")]
    for w in manifest["workloads"]:
        assert sum(w["name"] in m["workloads"] for m in rates) == 1
    for m in manifest["per_layer"]:
        moves = {e["name"]: e for e in manifest["end_to_end"]}[m["moves"]]
        assert set(m["workloads"]) <= set(moves["workloads"])


def _applies(m, cell):
    return "workloads" not in m or cell in m["workloads"]


def test_every_cell_reports_what_it_must(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    configs = {c["name"] for c in manifest["configs"]}
    pairs = set()
    for w in manifest["workloads"]:
        assert w["config"] in configs
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mine = [m["name"] for m in manifest["end_to_end"]
                if _applies(m, w["name"])]
        assert "setup_s" in mine and len(mine) >= 2
        layer = [m for m in manifest["per_layer"] if _applies(m, w["name"])]
        assert layer
        for m in layer:
            assert _applies(e2e[m["moves"]], w["name"])
    assert configs == {w["config"] for w in manifest["workloads"]}


def test_every_name_has_its_file(manifest):
    for c in manifest["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert os.path.exists(os.path.join(BENCH, "reference",
                                           conf["reference"] + ".py"))
    for w in manifest["workloads"]:
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
        with open(os.path.join(BENCH, "limits", w["name"] + ".json")) as f:
            limits = json.load(f)
        assert {"force_gap", "velocity_gap", "position_gap",
                "carried_changed"} <= set(limits)
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))


@pytest.mark.parametrize("kind", ["configs", "traffic", "limits", "metrics"])
def test_file_names_are_names(kind):
    for f in os.listdir(os.path.join(BENCH, kind)):
        if f != "__pycache__":
            assert re.match(r"^[A-Za-z0-9_.-]+$", f)
