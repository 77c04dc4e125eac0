from .bratu import (Bratu3DProblem, BratuProblem, NonlinearPoisson3DProblem,
                    NonlinearPoissonProblem, build_pointwise_hierarchy,
                    build_pointwise_hierarchy3)
from .anisotropic import (AnisotropicPoissonProblem, anisotropic_poisson_op,
                          build_anisotropic_hierarchy)
from .convection3d import (ConvectionDiffusion3DProblem, Directional7Op,
                           convection_diffusion_op3)
from .diffusion import DiffusionProblem, cell_coefficients
from .diffusion3d import (Diffusion3DProblem, build_diffusion3d_hierarchy,
                          cell_coefficients3)
from .helmholtz import HelmholtzProblem, helmholtz_op_host
from .nldiffusion import (QuasilinearDiffusion3DProblem,
                          QuasilinearDiffusionProblem,
                          build_quasilinear_hierarchy,
                          build_quasilinear_hierarchy3)
from .periodic import (PeriodicOp, PeriodicPoissonProblem,
                       build_periodic_hierarchy, periodic_coarse_pinv)
from .periodic3d import (Periodic3DPoissonProblem, PeriodicOp3,
                         build_periodic3_hierarchy, periodic3_coarse_pinv)
from .poisson import PoissonProblem, boundary_grid, poisson_rhs
from .poisson3d import Poisson3DProblem, boundary_grid3, poisson3d_rhs
from .poisson4_3d import Poisson4_3DProblem, mehrstellen_rhs3

__all__ = ["PoissonProblem", "DiffusionProblem", "HelmholtzProblem",
           "Poisson3DProblem", "Poisson4_3DProblem", "boundary_grid",
           "poisson_rhs", "boundary_grid3", "poisson3d_rhs",
           "mehrstellen_rhs3", "cell_coefficients", "helmholtz_op_host",
           "Diffusion3DProblem", "build_diffusion3d_hierarchy",
           "cell_coefficients3", "ConvectionDiffusion3DProblem",
           "Directional7Op", "convection_diffusion_op3",
           "AnisotropicPoissonProblem", "anisotropic_poisson_op",
           "build_anisotropic_hierarchy", "BratuProblem", "Bratu3DProblem",
           "NonlinearPoissonProblem", "NonlinearPoisson3DProblem",
           "build_pointwise_hierarchy", "build_pointwise_hierarchy3",
           "QuasilinearDiffusionProblem", "QuasilinearDiffusion3DProblem",
           "build_quasilinear_hierarchy", "build_quasilinear_hierarchy3",
           "PeriodicOp", "PeriodicPoissonProblem", "build_periodic_hierarchy",
           "periodic_coarse_pinv", "PeriodicOp3", "Periodic3DPoissonProblem",
           "build_periodic3_hierarchy", "periodic3_coarse_pinv"]
