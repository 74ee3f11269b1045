"""Each fault a cell can have, planted under the timed path of a run at a
tiny size on the CPU at the sites of the cell's family, turns ``correct``
false; the same run without it is correct (``test_lfmbench_harness``)."""

import importlib
import time

import pytest

from lfmbench import faults, harness
from lfmbench.tests.test_lfmbench_harness import CELLS, tiny


def _family(name):
    cfg = harness.load_cell(name).cfg
    return importlib.import_module(f"lfmbench.families.{cfg['family']}")


@pytest.mark.parametrize("name, kind", [(n, k) for n in CELLS for k in faults.kinds(_family(n))])
def test_a_planted_fault_is_not_correct(name, kind):
    cell = tiny(harness.load_cell(name))
    family = _family(name)
    with faults.plant(kind, family):
        out = harness.run(cell, 2**31 + 77, 0.3, False, "cpu", time.perf_counter())
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_calibration_readings_of_each_cell(name):
    """``calibrate``'s readings, as the cell's traffic kind takes them: the
    program within the cell's limits; the control and each fault, planted
    at the family's sites, outside them."""
    from lfmbench import calibrate

    cell = tiny(harness.load_cell(name))
    family = _family(name)
    rows = calibrate.readings(cell, 2**31 + 21, "cpu", control=True,
                              fault_kinds=faults.kinds(family), seconds=0.3)
    by = {r["reading"]: r for r in rows}
    assert list(by) == ["program", "control", *faults.kinds(family)]
    assert all(r["seed"] == 2**31 + 21 for r in rows)
    assert all(by["program"][k] <= limit for k, limit in cell.limits.items())
    for reading in ("control", *faults.kinds(family)):
        assert any(by[reading][k] > limit for k, limit in cell.limits.items()), by[reading]
    if cell.mix["kind"] == "fit":
        assert {"leaves", "reference"} <= set(by["program"]) and "leaves" in by["control"]
