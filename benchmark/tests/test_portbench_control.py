"""On the card, at each cell's own size: the control (the reference with
TF32 on, in the program's place) fails the cell's limits, and the
program passes them, on the same seed. Run on a card with
``python -m pytest benchmark/tests -q -m gpu``; skips elsewhere."""

import pytest
import torch

from benchmark import check
from benchmark.calibrate import readings
from benchmark.spec import Cell
from benchmark.tests._small import CELLS

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the cells run on the card)")
    from trpo_torch.ops import _build

    _build.build()
    return "cuda"


@pytest.mark.parametrize("cell_name", CELLS)
def test_control_fails_and_program_passes(card, cell_name):
    r = readings(cell_name, 7_000_000_003, card, control=True, faults=False)
    limits = Cell(cell_name).limits
    ok_program, prog = check.verdict(r["program"], limits)
    ok_control, ctrl = check.verdict(r["control"], limits)
    assert ok_program, prog
    assert not ok_control, ctrl
