from .poisson import PoissonProblem, boundary_grid, poisson_rhs

__all__ = ["PoissonProblem", "boundary_grid", "poisson_rhs"]
