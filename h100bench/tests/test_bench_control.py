"""The control, at a size a test run holds: the reference in the program's
place, in the lower precision the cell's limits file names (plain float32
refinement for the refined cells, bfloat16 cycles for the fixed one), fails
the cell's limits on three seeds, where the program at the same size passes.
On the card, at the cells' own sizes, ``readings.py`` reads both."""

import pytest

import check
import harness
from smallcells import CELLS, small_cell

# The CPU cut of each cell: deep enough that float32's floor lies above the
# refined cells' tol (it grows 4x a level in 2D, 2x in 3D here).
LEVELS = {"poisson2d-8193.refined-1e-7": (7, 3),
          "poisson3d-513.refined-1e-8": (5, 3),
          "poisson3d-513.vcycles-3": (5, 3)}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3])
def test_control_fails_the_limits(cell, seed):
    c = small_cell(cell, LEVELS[cell])
    (b,) = harness.make_pool(seed, c.config, dict(c.traffic, pool=1), "cpu")
    got = check.control(c.config, c.traffic, c.limits, b, "cpu")
    limits = {k: v["limit"] for k, v in c.limits["compare"].items()}
    assert any(got[k] > limits[k] for k in limits), (got, limits)
