"""On the card: the control, the reference in float32 with TF32 on put in
the program's place, fails at least one of a cell's numbers where the
program passes all of them, at test size.  The limits are set from the
same readings at the cells' own sizes (``python -m portbench.calibrate``,
PERF.md)."""

import pytest

from portbench import run as R
from portbench.tests import tiny


@pytest.mark.card
@pytest.mark.parametrize("name", ["resynth-1s", "corpus-b16",
                                  "soma-resynth-0.5s"])
def test_the_control_is_not_correct(name, card):
    cell = R.Cell(name, 2 ** 31 + 5, [card], workload=tiny.workload(name))
    _setup, _window, _peak, outputs, inputs = R.execute(cell, 0.05, 0, 0.0)
    program = R.checks_of(cell, R.judge(cell, outputs, inputs))
    control = R.checks_of(cell, R.judge(cell, outputs, inputs,
                                        control=True))
    assert R.is_correct(program), program
    assert not R.is_correct(control), control
