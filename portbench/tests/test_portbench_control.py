"""The control: the reference, computed in float32 (the nearest precision
below the configurations' float64), put in the program's place, comes out
not correct under each cell's limits."""

import pytest
import torch

from portbench import checks, data, harness
from portbench.tests import tiny


@pytest.mark.parametrize("name", tiny.CELLS)
def test_float32_control_is_not_correct(name):
    torch.set_num_threads(1)
    _bench, cell = tiny.cell(name)
    seed = 2**31 + 21
    u, N_k = data.oscillators(cell.config, seed, "cpu")
    out = harness.control_output(u, N_k, cell.traffic, seed, 1)
    numbers = {"failed_jobs": 0, **harness.compare(u, N_k, cell.traffic, [out])[0]}
    correct, rows = checks.judge(numbers, cell.limits)
    assert not correct, rows


@pytest.mark.parametrize("name", tiny.CELLS)
def test_float64_control_is_correct(name):
    """The same path in float64 passes: what fails above is the precision."""
    torch.set_num_threads(1)
    _bench, cell = tiny.cell(name)
    seed = 2**31 + 21
    u, N_k = data.oscillators(cell.config, seed, "cpu")
    out = harness.control_output(u, N_k, cell.traffic, seed, 1, dtype=torch.float64)
    numbers = {"failed_jobs": 0, **harness.compare(u, N_k, cell.traffic, [out])[0]}
    correct, rows = checks.judge(numbers, cell.limits)
    assert correct, rows
