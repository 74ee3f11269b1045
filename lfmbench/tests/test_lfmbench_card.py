"""On the card: each cell at its own size, a short window, correct; the
control read at the cell's own size fails the cell's limits. Run on a
machine with an H100 as ``python -m pytest lfmbench/tests -q -m cuda``."""

import time

import pytest

from lfmbench import harness
from lfmbench.tests.test_lfmbench_harness import CELLS


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card_is_correct(name):
    _card()
    out = harness.run(harness.load_cell(name), 2**31 + 3, 2.0, False, "cuda", time.perf_counter())
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limits_on_the_card(name):
    _card()
    from lfmbench import calibrate

    cell = harness.load_cell(name)
    rows = calibrate.readings(cell, 2**31 + 4, "cuda", control=True, seconds=2.0)
    control = [r for r in rows if r["reading"] == "control"][0]
    assert any(control[k] > limit for k, limit in cell.limits.items()), control
