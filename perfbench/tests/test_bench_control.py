"""The control of each cell's check, at a size a test run holds: the
reference computed in bfloat16, put in the program's place, must come out
not correct against the cell's limits.  On the card, at the cell's own
size: ``python3 perfbench/control.py``."""
import pytest

from perfbench import checks, manifest
from perfbench.control import control_values

SMALL = {"render": {"width": 16, "height": 16}, "traffic": {"check_pixels": 128}}
WORK = {"sphere_field.pt": 8, "textured_hall.pt": 8, "sphere_field.grad": 3,
        "sphere_field.pt.x4": 2}


@pytest.mark.parametrize("cell", sorted(WORK))
def test_bfloat16_control_is_not_correct(cell):
    limits = manifest.limits(cell)
    values = control_values(cell, 2**31 + 3, WORK[cell], device="cpu", overrides=SMALL)
    assert not checks.passed(checks.judge(values, limits)), values


@pytest.mark.card
def test_a_cell_runs_correct_on_the_card(card):
    """One short run of the cheapest cell on the card (``-m card``)."""
    from perfbench.run import run_cell

    r = run_cell("textured_hall.pt", 2**31 + 5, 3.0, False, device=card)
    assert r["correct"] and r["device"]["platform"] == "gpu", r["checks"]
