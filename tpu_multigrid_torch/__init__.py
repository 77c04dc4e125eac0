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
wind ``solve_convection_diffusion3d``) with K1v_3 and K2v_3 as CUDA kernels;
and the 2D anisotropic path (``solve_anisotropic``: a rotated constant
tensor, Galerkin coarse operators, zebra line relaxation on full
coarsening) with the zebra smoother, K1z and K2z as CUDA kernels; and the
nonlinear FAS tier in 2D and 3D (``solve_bratu``,
``solve_nonlinear_poisson``, ``solve_quasilinear_diffusion``) with K1f, K2f,
K1f_3 and K2f_3 as CUDA kernels; and the periodic torus
(``bc="periodic"`` of ``solve_poisson`` and ``solve_poisson3d``) with the
wrap-aware fused tier on K1-local and K2-local, the ghost-extended level-
visit kernels, as CUDA kernels (:mod:`tpu_multigrid_torch.kernels`); and
the distributed fused tier on ``torch.distributed``
(:mod:`tpu_multigrid_torch.dist`: ``solve_poisson(mesh=...,
dist_path="pallas")`` and the one-card 16385^2 refinement path) with K0-local
and the compensated refinement kernels on ghost-extended blocks; and its
nonlinear twin (``fas_sharded_solve_pallas``, behind the 2D FAS doors'
``mesh=..., dist_path="pallas"``) with K1f-local and K2f-local; and the
3D distributed fused tier (``sharded_solve_pallas3``,
``sharded_solve_pallas_var3``, ``sharded_solve_pallas_conv3`` on a
``make_grid_mesh3`` grid of ranks; library entries, no front door) with
K1_3-ext, K2_3-local and their variable-coefficient forms.  The front doors
run on the card unless the caller passes ``device``.
"""

from .api import (extract_solution, solve_anisotropic, solve_bratu,
                  solve_convection_diffusion3d, solve_diffusion,
                  solve_diffusion3d, solve_helmholtz, solve_nonlinear_poisson,
                  solve_poisson, solve_poisson3d, solve_quasilinear_diffusion)
from .config import REFERENCE_CONFIG, MultigridConfig, default_device
from .core import ops
from .core.grids import (Hierarchy, build_galerkin_hierarchy,
                         build_poisson_hierarchy)
from .core.nonlinear import (BratuNonlinearity, PointwiseNonlinearOp,
                             QuadraticCoefficient, QuasilinearFluxOp,
                             QuasilinearFluxOp3)
from .core.operators import VarStencilOp, VarStencilOp3D
from .cycles import SolveResult, cycle, fmg, solve_fixed, solve_until_tol
from .cycles.fas import (fas_cycle, fas_solve_fixed, fas_solve_until_tol,
                         fmg_fas)
from .dist.fas_pallas import fas_sharded_solve_pallas
from .dist.pallas_cycle3 import (sharded_solve_pallas3,
                                 sharded_solve_pallas_conv3,
                                 sharded_solve_pallas_var3)
from .dist.mesh import make_grid_mesh3
from .problems import (AnisotropicPoissonProblem, Bratu3DProblem,
                       BratuProblem, ConvectionDiffusion3DProblem,
                       Diffusion3DProblem, DiffusionProblem, HelmholtzProblem,
                       NonlinearPoisson3DProblem, NonlinearPoissonProblem,
                       Periodic3DPoissonProblem, PeriodicPoissonProblem,
                       Poisson3DProblem, Poisson4_3DProblem, PoissonProblem,
                       QuasilinearDiffusion3DProblem,
                       QuasilinearDiffusionProblem)

__all__ = [
    "MultigridConfig", "REFERENCE_CONFIG", "default_device", "solve_poisson",
    "solve_diffusion", "solve_helmholtz", "solve_poisson3d",
    "solve_diffusion3d", "solve_convection_diffusion3d", "solve_anisotropic",
    "extract_solution", "AnisotropicPoissonProblem",
    "PoissonProblem", "DiffusionProblem", "HelmholtzProblem",
    "Poisson3DProblem", "Poisson4_3DProblem", "Diffusion3DProblem",
    "ConvectionDiffusion3DProblem", "Hierarchy", "build_poisson_hierarchy",
    "build_galerkin_hierarchy", "VarStencilOp", "VarStencilOp3D",
    "cycle", "fmg", "solve_fixed", "solve_until_tol", "SolveResult", "ops",
    "solve_nonlinear_poisson", "solve_bratu", "solve_quasilinear_diffusion",
    "BratuProblem", "Bratu3DProblem", "NonlinearPoissonProblem",
    "NonlinearPoisson3DProblem", "QuasilinearDiffusionProblem",
    "QuasilinearDiffusion3DProblem", "BratuNonlinearity",
    "QuadraticCoefficient", "PointwiseNonlinearOp", "QuasilinearFluxOp",
    "QuasilinearFluxOp3", "fas_cycle", "fas_solve_fixed",
    "fas_solve_until_tol", "fmg_fas", "PeriodicPoissonProblem",
    "Periodic3DPoissonProblem", "fas_sharded_solve_pallas",
    "make_grid_mesh3", "sharded_solve_pallas3", "sharded_solve_pallas_var3",
    "sharded_solve_pallas_conv3",
]
