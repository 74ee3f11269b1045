"""Each fault a cell can have, planted under the timed path of a run at a
tiny size on the CPU, turns ``correct`` false; the same run without it is
correct (``test_lfmbench_harness``)."""

import time

import pytest

from lfmbench import faults, harness
from lfmbench.tests.test_lfmbench_harness import CELLS, tiny


@pytest.mark.parametrize("kind", faults.KINDS)
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(name, kind):
    cell = tiny(harness.load_cell(name))
    with faults.plant(kind):
        out = harness.run(cell, 2**31 + 77, 0.3, False, "cpu", time.perf_counter())
    assert out["correct"] is False, out["checks"]
