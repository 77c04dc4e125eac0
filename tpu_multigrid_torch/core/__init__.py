from . import ops
from .grids import (Hierarchy, build_poisson_hierarchy, coarse_dense_inverse,
                    coarse_solve, level_sizes)
from .operators import ConstStencilOp, poisson_op

__all__ = ["ops", "Hierarchy", "build_poisson_hierarchy",
           "coarse_dense_inverse", "coarse_solve", "level_sizes",
           "ConstStencilOp", "poisson_op"]
