"""The control: the reference with every product's operands rounded to fp8
(the step below the configurations' bf16) put in the program's place
reads beyond a limit of its cell, at the tiny size on the CPU and, on a
card, at the cell's own size."""

from __future__ import annotations

import pytest

from portbench.calibrate import control_numbers
from portbench.cell import load_cell
from portbench.compare import passed, with_limits

CELLS = ["badwinner2.train-b128", "badwinner2.serve-b256"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_at_the_tiny_size(tiny, cell):
    c = load_cell(cell, 3000000023, 1.0, False, "cpu", tiny)
    numbers, _ = control_numbers(c)
    assert not passed(with_limits(numbers, c.workload["limits"])), numbers


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [3000000031, 3000000032, 3000000033])
def test_the_control_is_not_correct_at_the_cells_size(card, cell, seed):
    c = load_cell(cell, seed, 1.0, False, card)
    numbers, _ = control_numbers(c)
    assert not passed(with_limits(numbers, c.workload["limits"])), numbers
