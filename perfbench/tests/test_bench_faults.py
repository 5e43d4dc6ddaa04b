"""Each cell's check against faults planted under its timed path, run on
the CPU at a small size with the look for a card skipped: every fault must
come out not correct, and the sound program correct."""
import pytest

from perfbench.run import run_cell
from perfbench.tests import _faults

SMALL = {"render": {"width": 16, "height": 16},
         "traffic": {"check_pixels": 128, "trace_frames": 2, "trace_batches": 2}}
SECONDS = {"sphere_field.pt": 6.0, "textured_hall.pt": 3.0, "sphere_field.grad": 2.0,
           "sphere_field.pt.x4": 3.0}


def _run(cell, seed=2**31 + 7):
    return run_cell(cell, seed, SECONDS[cell], False, device="cpu", overrides=SMALL)


def _progressive_fault(mp, fault):
    import mcrt_tpu_torch.renderer as renderer

    if fault == "state_unchanged":
        mp.setattr(renderer.Renderer, "step", lambda self, n_frames=1: self.accum)
    elif fault == "half_the_batch":
        mp.setattr(renderer, "render_frame_fn", _faults.half_frames(renderer.render_frame_fn))
    else:
        mp.setattr(renderer, "build_intersector",
                   _faults.altered_intersector(renderer.build_intersector))


def _grad_fault(mp, fault):
    import torch

    import mcrt_tpu_torch.accel as accel
    from mcrt_tpu_torch.diff import estimators

    if fault == "state_unchanged":
        mp.setattr(torch.optim.Adam, "step", _faults.frozen_adam_step)
    elif fault == "half_the_batch":
        mp.setattr(estimators, "render_loss_fn", _faults.half_pixels_loss)
    else:
        mp.setattr(accel, "build_intersector", _faults.altered_intersector(accel.build_intersector))


FAULTS = ["state_unchanged", "half_the_batch", "answer_altered"]


@pytest.mark.parametrize("cell", ["sphere_field.pt", "textured_hall.pt"])
@pytest.mark.parametrize("fault", FAULTS)
def test_progressive_fault_is_caught(monkeypatch, cell, fault):
    _progressive_fault(monkeypatch, fault)
    assert _run(cell)["correct"] is False


@pytest.mark.parametrize("fault", FAULTS)
def test_grad_fault_is_caught(monkeypatch, fault):
    _grad_fault(monkeypatch, fault)
    assert _run("sphere_field.grad")["correct"] is False


@pytest.mark.parametrize("rank_fn", ["rank_without_exchange", "rank_with_stale_batches",
                                     "rank_with_altered_hits"])
def test_sharded_fault_is_caught(monkeypatch, rank_fn):
    from perfbench.loops import sharded

    monkeypatch.setattr(sharded, "_rank", getattr(_faults, rank_fn))
    assert _run("sphere_field.pt.x4")["correct"] is False


@pytest.mark.parametrize("cell", ["sphere_field.pt", "textured_hall.pt", "sphere_field.grad",
                                  "sphere_field.pt.x4"])
def test_sound_program_is_correct(cell):
    r = _run(cell)
    assert r["correct"] is True, r["checks"]


def _children() -> set:
    """Pids of this process's live children, from ``/proc``."""
    import os

    kids = set()
    for p in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{p}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == os.getpid() and fields[0] != "Z":
            kids.add(int(p))
    return kids


def test_sharded_run_leaves_no_process():
    before = _children()
    assert _run("sphere_field.pt.x4", seed=2**31 + 13)["correct"] is True
    assert _children() <= before
