"""Distributed solves on a grid of ranks (``torch.distributed``).

Ported so far: the fused tier of the JAX package's ``tpu_multigrid.dist``
(:mod:`.pallas_cycle`: V/W/F cycles, FMG and the until-tol driver on
ghost-extended blocks through K1-local and K2-local; :mod:`.refine_pallas`:
double- and triple-single refinement with the double-single cycle on the
compensated kernels; :mod:`.fas_pallas`: the nonlinear FAS cycles on
K1f-local and K2f-local, with :mod:`.fas`'s replicated tail;
:mod:`.pallas_cycle3`: the 3D Poisson, variable-coefficient and
convection-diffusion solvers on K1_3-ext / K2_3-local and their var forms,
on a (gz, gy) grid of ranks), with its mesh and transport (:mod:`.mesh`),
the plain rank-local operators it reads (:mod:`.local_ops`) and a launcher
of rank processes (:mod:`.launch`).
"""

from .fas_pallas import fas_sharded_solve_pallas
from .launch import run_on_mesh
from .local_ops import gather_full
from .mesh import GridMesh, make_grid_mesh, make_grid_mesh3
from .pallas_cycle import sharded_solve_pallas
from .pallas_cycle3 import (sharded_solve_pallas3, sharded_solve_pallas_conv3,
                            sharded_solve_pallas_var3)
from .refine_pallas import refined_sharded_solve_pallas

__all__ = ["GridMesh", "make_grid_mesh", "run_on_mesh", "gather_full",
           "sharded_solve_pallas", "refined_sharded_solve_pallas",
           "fas_sharded_solve_pallas", "make_grid_mesh3",
           "sharded_solve_pallas3", "sharded_solve_pallas_var3",
           "sharded_solve_pallas_conv3"]
