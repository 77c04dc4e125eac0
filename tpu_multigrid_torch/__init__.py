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
the var-stencil smoother, K1v and K2v as CUDA kernels; and the 3D
constant-coefficient path (``solve_poisson3d``: the 7-point and 19-point
Mehrstellen stencils, FMG, refinement) with the 3D streaming smoother, K1_3
and K2_3 as CUDA kernels; and the 3D variable-coefficient path
(``solve_diffusion3d``, with an optional reaction term, and the variable-
wind ``solve_convection_diffusion3d``) with K1v_3 and K2v_3 as CUDA kernels
(:mod:`tpu_multigrid_torch.kernels`).  The front doors run on the card
unless the caller passes ``device``.
"""

from .api import (extract_solution, solve_convection_diffusion3d,
                  solve_diffusion, solve_diffusion3d, solve_helmholtz,
                  solve_poisson, solve_poisson3d)
from .config import REFERENCE_CONFIG, MultigridConfig, default_device
from .core import ops
from .core.grids import (Hierarchy, build_galerkin_hierarchy,
                         build_poisson_hierarchy)
from .core.operators import VarStencilOp, VarStencilOp3D
from .cycles import SolveResult, cycle, fmg, solve_fixed, solve_until_tol
from .problems import (ConvectionDiffusion3DProblem, Diffusion3DProblem,
                       DiffusionProblem, HelmholtzProblem, Poisson3DProblem,
                       Poisson4_3DProblem, PoissonProblem)

__all__ = [
    "MultigridConfig", "REFERENCE_CONFIG", "default_device", "solve_poisson",
    "solve_diffusion", "solve_helmholtz", "solve_poisson3d",
    "solve_diffusion3d", "solve_convection_diffusion3d", "extract_solution",
    "PoissonProblem", "DiffusionProblem", "HelmholtzProblem",
    "Poisson3DProblem", "Poisson4_3DProblem", "Diffusion3DProblem",
    "ConvectionDiffusion3DProblem", "Hierarchy", "build_poisson_hierarchy",
    "build_galerkin_hierarchy", "VarStencilOp", "VarStencilOp3D",
    "cycle", "fmg", "solve_fixed", "solve_until_tol", "SolveResult", "ops",
]
