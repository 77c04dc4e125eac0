from . import ops
from .grids import (Hierarchy, build_galerkin_hierarchy,
                    build_poisson_hierarchy, coarse_dense_inverse,
                    coarse_solve, level_sizes)
from .operators import (ConstStencilOp, VarStencilOp, diffusion_op,
                        diffusion_op_host, galerkin_coarsen,
                        galerkin_coarsen_host, poisson_op)

__all__ = ["ops", "Hierarchy", "build_poisson_hierarchy",
           "build_galerkin_hierarchy", "coarse_dense_inverse", "coarse_solve",
           "level_sizes", "ConstStencilOp", "VarStencilOp", "poisson_op",
           "diffusion_op", "diffusion_op_host", "galerkin_coarsen",
           "galerkin_coarsen_host"]
