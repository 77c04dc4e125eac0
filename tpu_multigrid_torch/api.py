"""Front-door solve API: single-device Dirichlet solves of Poisson,
variable-coefficient diffusion and shifted-Poisson (Helmholtz) problems.

Every entry runs on ``device``; ``device=None`` means the card
(``config.default_device``), and raises where there is none.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from .config import MultigridConfig
from .cycles import SolveResult, fmg, solve_fixed, solve_until_tol
from .problems.diffusion import DiffusionProblem
from .problems.helmholtz import HelmholtzProblem
from .problems.poisson import PoissonProblem, boundary_grid


def solve_poisson(
    finest_level: int = 10,
    *,
    config: Optional[MultigridConfig] = None,
    forcing: Union[float, Callable] = 4.0,
    boundary: Optional[Union[float, Callable]] = None,
    tol: Optional[float] = 1e-8,
    max_cycles: int = 100,
    num_cycles: Optional[int] = None,
    use_fmg: bool = False,
    refined: Optional[bool] = None,
    neumann=(),
    mesh=None,
    order: int = 2,
    bc: str = "dirichlet",
    device: Union[str, torch.device, None] = None,
) -> SolveResult:
    """Solve -lap(u) = forcing on the unit square, on ``device`` (the card
    when None).

    Returns a :class:`SolveResult`; ``result.u`` is the (S, S) node grid
    (physical nodes at ``[0:n+1, 0:n+1]``).  ``num_cycles`` forces a fixed
    cycle count; otherwise cycles run until ``tol`` relative residual
    reduction.  ``use_fmg=True`` runs one full-multigrid pass first.
    ``refined=True`` uses compensated double-single iterative refinement
    (:mod:`tpu_multigrid_torch.precision`).  The default ``refined=None``
    selects it whenever ``tol`` is below 1e-5 with float32 storage, where
    the plain f32 iterate cannot converge.  ``boundary`` (a constant or
    ``g(x, y)``) imposes inhomogeneous Dirichlet values via lifting.

    Not ported yet (each raises ``NotImplementedError``): ``mesh``,
    ``neumann``, ``bc="periodic"``, ``order=4``, and a ``smooth_dtype``
    other than ``dtype``.
    """
    config = _level_config(config, finest_level)
    _check_single_device(config, mesh)
    if neumann:
        raise NotImplementedError("neumann sides are not ported yet")
    if bc == "periodic":
        raise NotImplementedError('bc="periodic" is not ported yet')
    if bc != "dirichlet":
        raise ValueError(f'bc must be "dirichlet" or "periodic", got {bc!r}')
    if order == 4:
        raise NotImplementedError("order=4 (Mehrstellen) is not ported yet")
    if order != 2:
        raise ValueError(f"order must be 2 or 4, got {order}")
    if refined is None:
        # A tol below the f32 residual floor cannot converge in the plain
        # f32 iterate: route it through compensated refinement.
        refined = (tol is not None and tol < 1e-5
                   and config.dtype == torch.float32)
    problem = PoissonProblem(config, forcing=forcing, device=device,
                             **_pad_kw(config))
    return _run(problem, config, tol, max_cycles, num_cycles, use_fmg,
                refined=refined, boundary=boundary)


def solve_diffusion(
    finest_level: int = 10,
    *,
    coefficient: Union[float, Callable] = 1.0,
    config: Optional[MultigridConfig] = None,
    forcing: Union[float, Callable] = 4.0,
    boundary: Optional[Union[float, Callable]] = None,
    tol: Optional[float] = 1e-8,
    max_cycles: int = 100,
    num_cycles: Optional[int] = None,
    use_fmg: bool = False,
    mesh=None,
    u0=None,
    device: Union[str, torch.device, None] = None,
) -> SolveResult:
    """Solve -div(a grad u) = forcing with per-cell coefficients ``a`` (a
    constant or ``a(x, y)``, evaluated on torch tensors at the cell centres)
    on ``device`` (the card when None).  The coarse operators are Galerkin
    products, built on the host once and uploaded.  ``boundary`` lifts
    inhomogeneous Dirichlet values as in :func:`solve_poisson`.

    ``mesh`` raises ``NotImplementedError`` (not ported yet).  ``u0`` is a
    starting guess of the distributed path only: the JAX package's
    single-device ``solve_diffusion`` takes it and ignores it; here it
    raises.
    """
    config = _level_config(config, finest_level)
    _check_single_device(config, mesh)
    if u0 is not None:
        raise ValueError("u0 is taken only with mesh= (distributed solves, "
                         "not ported yet); the single-device solve starts "
                         "from zero or from use_fmg")
    problem = DiffusionProblem(config, coefficient=coefficient,
                               forcing=forcing, device=device,
                               **_pad_kw(config))
    return _run(problem, config, tol, max_cycles, num_cycles, use_fmg,
                boundary=boundary)


def solve_helmholtz(
    finest_level: int = 10,
    *,
    shift: Union[float, Callable] = 1.0,
    config: Optional[MultigridConfig] = None,
    forcing: Union[float, Callable] = 4.0,
    boundary: Optional[Union[float, Callable]] = None,
    tol: Optional[float] = 1e-8,
    max_cycles: int = 100,
    num_cycles: Optional[int] = None,
    use_fmg: bool = False,
    mesh=None,
    device: Union[str, torch.device, None] = None,
) -> SolveResult:
    """Solve -lap(u) + shift*u = forcing (reaction-diffusion / shifted
    Poisson) on ``device`` (the card when None).  ``shift`` is a constant
    c >= 0 or ``c(x, y)``, evaluated on float64 torch tensors at the nodes;
    every level re-discretizes with diagonal 4 + c h².  It runs on the
    variable-coefficient machinery, kernels included.  ``mesh`` raises
    ``NotImplementedError`` (not ported yet).
    """
    config = _level_config(config, finest_level)
    _check_single_device(config, mesh)
    problem = HelmholtzProblem(config, shift=shift, forcing=forcing,
                               device=device, **_pad_kw(config))
    return _run(problem, config, tol, max_cycles, num_cycles, use_fmg,
                boundary=boundary)


def _level_config(config: Optional[MultigridConfig],
                  finest_level: int) -> MultigridConfig:
    if config is None:
        return MultigridConfig(finest_level=finest_level)
    if config.finest_level != finest_level:
        return dataclasses.replace(config, finest_level=finest_level)
    return config


def _check_single_device(config: MultigridConfig, mesh) -> None:
    """The front doors' options that are not ported yet raise."""
    if mesh is not None:
        raise NotImplementedError("distributed solves (mesh=) are not "
                                  "ported yet")
    if config.effective_smooth_dtype != config.dtype:
        raise NotImplementedError("smooth_dtype other than dtype (the delta "
                                  "form) is not ported yet")


def _pad_kw(config: MultigridConfig) -> dict:
    """The kernels take 256-aligned level padding (``kernels.transfer.
    supported``): pad every level so they cover the whole hierarchy."""
    if config.use_kernels:
        return dict(align=256, min_pad_level=0)
    return {}


def _run(problem, config, tol, max_cycles, num_cycles, use_fmg,
         refined: bool = False, boundary=None) -> SolveResult:
    hier = problem.hierarchy
    b = problem.rhs()
    lift = None
    if boundary is not None:
        # u = w + G, G holding the boundary values; w solves A w = b - A G.
        op0 = hier.levels[0]
        lift = boundary_grid(op0.n, op0.S, boundary, config.dtype, b.device)
        b = b - op0.apply(lift)
    if tol is None and num_cycles is None:
        raise ValueError("need either tol or num_cycles (both are None)")
    u0 = fmg(hier, config, b) if use_fmg else None
    if refined:
        from .precision import solve_refined
        res = solve_refined(hier, config, b, tol=tol, max_iters=max_cycles,
                            num_cycles=num_cycles, u0=u0)
    elif num_cycles is not None:
        res = solve_fixed(hier, config, b, num_cycles, u0=u0)
    else:
        res = solve_until_tol(hier, config, b, tol=tol,
                              max_cycles=max_cycles, u0=u0)
    if lift is not None:
        res = dataclasses.replace(res, u=res.u + lift)
    return res


def extract_solution(result_u: torch.Tensor, n: int) -> torch.Tensor:
    """Crop the padded solve grid to the physical (n+1, n+1) node grid."""
    return result_u[..., :n + 1, :n + 1]
