"""A whole run of each cell on the CPU at a small size, past the harness's
look for a card: sound, it is correct; with the timed path broken
underneath, or with the bfloat16 control in its place, it is not."""

import pytest
import torch

from conftest import MANIFEST

from nbody_bench import calibrate, harness
from parallel_nbody_tpu_torch.models import engine

CELLS = ["k1_64k_glibc", "k2_1m_uniform", "k1_64k_frames",
         "k1_64k_uniform"]
SEED = 2**31 + 1234


def _run(workload, control=None, **overrides):
    cell = harness.load_cell(MANIFEST, workload,
                             dict({"n": 384, "chunk_steps": 4}, **overrides))
    if cell.traffic.get("frame_every"):
        cell.traffic = dict(cell.traffic, frame_every=3)
    return harness.run(cell, SEED, 0.3, False, torch.device("cpu"),
                       control=control)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    out = _run(workload)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0


def _unchanged(monkeypatch):
    monkeypatch.setattr(engine, "step", lambda cfg, s: s)


def _half_left_out(monkeypatch):
    forces = engine.cuda_forces

    def half(cfg, x, y, mass, radius, **kw):
        kept = mass.clone()
        kept[x.shape[0] // 2:] = 0
        fx, fy = forces(cfg, x, y, kept, radius, **kw)
        return 2 * fx, 2 * fy

    monkeypatch.setattr(engine, "cuda_forces", half)


def _answer_altered(monkeypatch):
    forces = engine.cuda_forces

    def altered(*a, **kw):
        fx, fy = forces(*a, **kw)
        fx = fx.clone()
        fx[7] = -fx[7]
        return fx, fy

    monkeypatch.setattr(engine, "cuda_forces", altered)


def _chunk_short(monkeypatch):
    # A call of several steps runs one fewer; a call of one step is sound.
    run = engine.run
    monkeypatch.setattr(engine, "run", lambda cfg, s, steps, **kw: run(
        cfg, s, steps - 1 if steps > 1 else steps, **kw))


def _chunk_unchanged(monkeypatch):
    # A call of several steps returns its state; one step is sound.
    run = engine.run
    monkeypatch.setattr(engine, "run", lambda cfg, s, steps, **kw: (
        s if steps > 1 else run(cfg, s, steps, **kw)))


FAULTS = {"unchanged": _unchanged, "half_left_out": _half_left_out,
          "answer_altered": _answer_altered, "chunk_short": _chunk_short,
          "chunk_unchanged": _chunk_unchanged}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(monkeypatch, workload, fault):
    FAULTS[fault](monkeypatch)
    out = _run(workload)
    assert not out["correct"]
    assert out["failed"] >= 1


def test_altered_frame_is_not_correct(monkeypatch):
    render = harness.render_frame

    def altered(*a, **kw):
        frame = render(*a, **kw).clone()
        frame[:64, :64] = 255
        return frame

    monkeypatch.setattr(harness, "render_frame", altered)
    out = _run("k1_64k_frames")
    assert not out["correct"]
    assert out["checks"]["frame_pixels.frame"]["value"] > \
        out["checks"]["frame_pixels.frame"]["limit"]


def test_a_short_chunk_is_caught_by_the_chunk_check(monkeypatch):
    _chunk_short(monkeypatch)
    out = _run("k1_64k_uniform")
    bad = [k for k, c in out["checks"].items()
           if not c["value"] <= c["limit"]]
    assert bad == ["chunk_gap.end"], out["checks"]


@pytest.mark.parametrize("fault", ["half_left_out", None])
def test_sampled_rows(fault, monkeypatch):
    """With ``check_rows`` under the bodies, the step checks hold that
    many; a fault of every row still fails."""
    if fault:
        FAULTS[fault](monkeypatch)
    out = _run("k2_1m_uniform", check_rows=100)
    assert out["correct"] is (fault is None), out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_bf16_control_fails(workload):
    out = _run(workload, control=calibrate.bf16_control)
    assert out["correct"], out["checks"]
    assert out["control_correct"] is False, out["control"]
    limits = {k: v["limit"] for k, v in out["checks"].items()}
    over = [k for k, v in out["control"].items() if not v <= limits[k]]
    assert any(k.endswith(".end") for k in over), out["control"]
    if "frame_pixels.frame" in out["control"]:
        assert "frame_pixels.frame" in over
