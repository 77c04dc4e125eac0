from .diffusion import DiffusionProblem, cell_coefficients
from .helmholtz import HelmholtzProblem, helmholtz_op_host
from .poisson import PoissonProblem, boundary_grid, poisson_rhs

__all__ = ["PoissonProblem", "DiffusionProblem", "HelmholtzProblem",
           "boundary_grid", "poisson_rhs", "cell_coefficients",
           "helmholtz_op_host"]
