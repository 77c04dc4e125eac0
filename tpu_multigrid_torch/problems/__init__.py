from .convection3d import (ConvectionDiffusion3DProblem, Directional7Op,
                           convection_diffusion_op3)
from .diffusion import DiffusionProblem, cell_coefficients
from .diffusion3d import (Diffusion3DProblem, build_diffusion3d_hierarchy,
                          cell_coefficients3)
from .helmholtz import HelmholtzProblem, helmholtz_op_host
from .poisson import PoissonProblem, boundary_grid, poisson_rhs
from .poisson3d import Poisson3DProblem, boundary_grid3, poisson3d_rhs
from .poisson4_3d import Poisson4_3DProblem, mehrstellen_rhs3

__all__ = ["PoissonProblem", "DiffusionProblem", "HelmholtzProblem",
           "Poisson3DProblem", "Poisson4_3DProblem", "boundary_grid",
           "poisson_rhs", "boundary_grid3", "poisson3d_rhs",
           "mehrstellen_rhs3", "cell_coefficients", "helmholtz_op_host",
           "Diffusion3DProblem", "build_diffusion3d_hierarchy",
           "cell_coefficients3", "ConvectionDiffusion3DProblem",
           "Directional7Op", "convection_diffusion_op3"]
