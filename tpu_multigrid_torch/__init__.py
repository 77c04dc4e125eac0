"""tpu_multigrid_torch: the multigrid solver in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``tpu_multigrid``, which stays the reference:
modules keep its names and its ``(n, S)`` level layout, so every array
compares elementwise.  This package imports torch and numpy and never JAX.
Ported so far: the 2D constant-coefficient Poisson solve (V/W/F cycles,
FMG, fixed and until-tol drivers, double- and triple-single refinement
with the double-single cycle, the ``solve_poisson`` front door), with K1,
K2, the compensated residual, the streaming smoother and the standalone
transfers as CUDA kernels; and the 2D variable-coefficient path
(``solve_diffusion`` with a Galerkin hierarchy, ``solve_helmholtz``) with
the var-stencil smoother, K1v and K2v as CUDA kernels
(:mod:`tpu_multigrid_torch.kernels`).  The front doors run on the card
unless the caller passes ``device``.
"""

from .api import (extract_solution, solve_diffusion, solve_helmholtz,
                  solve_poisson)
from .config import REFERENCE_CONFIG, MultigridConfig, default_device
from .core import ops
from .core.grids import (Hierarchy, build_galerkin_hierarchy,
                         build_poisson_hierarchy)
from .core.operators import VarStencilOp
from .cycles import SolveResult, cycle, fmg, solve_fixed, solve_until_tol
from .problems import DiffusionProblem, HelmholtzProblem, PoissonProblem

__all__ = [
    "MultigridConfig", "REFERENCE_CONFIG", "default_device", "solve_poisson",
    "solve_diffusion", "solve_helmholtz", "extract_solution",
    "PoissonProblem", "DiffusionProblem", "HelmholtzProblem", "Hierarchy",
    "build_poisson_hierarchy", "build_galerkin_hierarchy", "VarStencilOp",
    "cycle", "fmg", "solve_fixed", "solve_until_tol", "SolveResult", "ops",
]
