"""Each control of each cell (the port's own path one step of precision
lower, or the reference computed so, named by ``limits/<workload>.json``)
fails the cell's limits, at the cell's own sizes, on three seeds. On the
card only::

    python3 -m pytest port_bench/tests -m card -q
"""

import pytest

from port_bench import calibrate, cells, compare

CONTROLS = [(w["name"], c) for w in cells.load_json(cells.BENCHMARK)["workloads"]
            for c in cells.load_json(cells.path_of("limits", w["name"], ".json"))["controls"]]


@pytest.mark.card
@pytest.mark.parametrize("name,control", CONTROLS)
@pytest.mark.parametrize("seed", [3_000_000_101, 3_000_000_102, 3_000_000_103])
def test_control_is_not_correct(name, control, seed, card):
    cell = cells.cell(name)
    numbers = calibrate.control_reading(cell, control, seed, card)
    correct, checks = compare.judge(numbers, cell.limits)
    assert not correct, checks
