"""The control (the plain reference with float8 matrix products, in the
program's place) comes out not correct.  On the card at the cell's own
size against the cell's limits; on the CPU at smoke size, as a ratio."""
import pytest

from portbench.tests.smoke import CELLS, cuda_device, small_cell  # noqa: F401
from portbench import calibrate
from portbench.harness import spec


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [3, 2 ** 33 + 1])
def test_control_reads_far_from_the_program_at_smoke_size(name, seed):
    cell = small_cell(name)
    r = calibrate.readings_for(cell, seed, "cpu", control=True)
    assert r["control"]["logit_rel_err"] > 3 * r["program"]["logit_rel_err"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_cells_limits_on_card(cuda_device, name):
    cell = spec.load_cell(name)
    for seed in (7000000001, 7000000002, 7000000003):
        r = calibrate.readings_for(cell, seed, cuda_device, control=True)
        assert r["program_passes"], r
        assert not r["control_passes"], r
