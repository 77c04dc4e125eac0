"""The benchmark's cells cut to a size the CPU runs in seconds."""

import copy
from pathlib import Path

import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("poisson2d-8193.refined-1e-7", "poisson3d-513.refined-1e-8",
         "poisson3d-513.vcycles-3")
# Levels (finest, coarsest) of each configuration's CPU cut.
SMALL = {2: (6, 3), 3: (5, 3)}


def levels_of(config: dict):
    """[n, shape] of each level by the padding the problem class is given:
    every axis n+1 rounded up to ``align``, the last to ``lane_align``
    where given."""
    mg, kw = config["multigrid"], config["problem"]["kwargs"]
    up = lambda x, m: -(-x // m) * m  # noqa: E731
    return [[2 ** lvl,
             [up(2 ** lvl + 1, kw["align"])] * (config["ndim"] - 1)
             + [up(2 ** lvl + 1, kw.get("lane_align", kw["align"]))]]
            for lvl in range(mg["finest_level"], mg["coarsest_level"] - 1,
                             -1)]


def small_cell(name: str, levels=None) -> harness.Cell:
    """The cell with its configuration cut to a few levels."""
    cell = harness.load_cell(ROOT, name)
    cfg = copy.deepcopy(cell.config)
    fine, coarse = levels or SMALL[cfg["ndim"]]
    cfg["multigrid"]["finest_level"] = fine
    cfg["multigrid"]["coarsest_level"] = coarse
    cfg["levels"] = levels_of(cfg)
    cell.config = cfg
    return cell


def run_small(name: str, seconds: float = 0.5, trace: bool = False,
              seed: int = 2 ** 31 + 77, levels=None):
    """One run of the cut cell on the CPU: (result, check lines)."""
    import time
    return harness.run_cell(ROOT, name, seed, seconds, trace,
                            time.perf_counter(), device="cpu",
                            cell=small_cell(name, levels))
