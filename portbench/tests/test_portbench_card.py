"""On the card: each cell's control comes out not correct and the program
correct, at the cell's own size, on one seed and every pool batch once.

    python -m pytest portbench/tests -m card

The control of a cell is the one its configuration names (``control``,
one of ``control.CONTROLS``). Skips without a card.
"""

import json

import pytest

from portbench import control, spec
from portbench.run import Bench, is_correct

CELLS = [w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_and_the_program_passes(card, name):
    cell = spec.load_cell(name)
    b = Bench(cell, 2**31 + 4242, card)
    k = len(b.pool)
    prog = b.window(0, batches=k)
    ctrl = control._window_with(b, k, **control.CONTROLS[cell.config["control"]])
    b.release()
    want = b.expected()
    assert is_correct(b.checks(want, prog))
    assert not is_correct(b.checks(want, ctrl))
