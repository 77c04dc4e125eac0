"""tpu_multigrid_torch: the multigrid solver in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``tpu_multigrid``, which stays the reference:
modules keep its names and its ``(n, S)`` level layout, so every array
compares elementwise.  This package imports torch and numpy and never JAX.
Ported so far: the 2D constant-coefficient Poisson solve (V/W/F cycles,
FMG, fixed and until-tol drivers, double- and triple-single refinement
with the double-single cycle, the ``solve_poisson`` front door), with K1,
K2, the compensated residual, the streaming smoother and the standalone
transfers as CUDA kernels (:mod:`tpu_multigrid_torch.kernels`).
"""

from .api import extract_solution, solve_poisson
from .config import REFERENCE_CONFIG, MultigridConfig
from .core import ops
from .core.grids import Hierarchy, build_poisson_hierarchy
from .cycles import SolveResult, cycle, fmg, solve_fixed, solve_until_tol
from .problems import PoissonProblem

__all__ = [
    "MultigridConfig", "REFERENCE_CONFIG", "solve_poisson",
    "extract_solution", "PoissonProblem", "Hierarchy",
    "build_poisson_hierarchy", "cycle", "fmg", "solve_fixed",
    "solve_until_tol", "SolveResult", "ops",
]
