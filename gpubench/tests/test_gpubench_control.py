"""The control, kept at a size the tests hold: the reference computed a
precision below the configuration's, put in the program's place, is
rejected by the comparison (``gpubench/control.py`` runs it at the cells'
own size on the card's machine)."""

import pytest

from conftest import tiny
from gpubench.control import control_numbers


@pytest.mark.parametrize("seed", [3, 3_000_000_017, 2**31 + 99])
def test_control_is_rejected(seed):
    numbers = control_numbers(tiny("nb_all.live16"), seed, seconds=2.0)
    assert any(v > 0 for v in numbers.values()), numbers
