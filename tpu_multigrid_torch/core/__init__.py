from . import ops, ops3d
from .grids import (Hierarchy, build_galerkin_hierarchy,
                    build_poisson_hierarchy, coarse_dense_inverse,
                    coarse_solve, level_sizes)
from .operators import (Const19Op, ConstStencilOp, ConstStencilOp3D,
                        VarStencilOp, VarStencilOp3D, diffusion_op,
                        diffusion_op3_host, diffusion_op_host,
                        galerkin_coarsen, galerkin_coarsen_host, poisson_op)

__all__ = ["ops", "ops3d", "Const19Op", "ConstStencilOp3D", "Hierarchy",
           "build_poisson_hierarchy", "build_galerkin_hierarchy",
           "coarse_dense_inverse", "coarse_solve", "level_sizes",
           "ConstStencilOp", "VarStencilOp", "VarStencilOp3D", "poisson_op",
           "diffusion_op", "diffusion_op_host", "diffusion_op3_host",
           "galerkin_coarsen", "galerkin_coarsen_host"]
