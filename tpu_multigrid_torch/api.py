"""Front-door solve API: single-device Dirichlet solves of Poisson (2D and
3D), variable-coefficient diffusion (2D and 3D), shifted-Poisson
(Helmholtz) and 3D convection-diffusion problems.

Every entry runs on ``device``; ``device=None`` means the card
(``config.default_device``), and raises where there is none.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from .config import MultigridConfig, default_device
from .cycles import SolveResult, fmg, solve_fixed, solve_until_tol
from .problems.convection3d import ConvectionDiffusion3DProblem
from .problems.diffusion import DiffusionProblem
from .problems.diffusion3d import Diffusion3DProblem
from .problems.helmholtz import HelmholtzProblem
from .problems.poisson import PoissonProblem, boundary_grid
from .problems.poisson3d import Poisson3DProblem, boundary_grid3
from .problems.poisson4_3d import Poisson4_3DProblem


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


def solve_poisson3d(
    finest_level: int = 6,
    *,
    config: Optional[MultigridConfig] = None,
    forcing: Union[float, Callable] = 6.0,
    tol: Optional[float] = 1e-8,
    max_cycles: int = 100,
    num_cycles: Optional[int] = None,
    use_fmg: bool = False,
    refined: bool = False,
    mesh=None,
    bc: str = "dirichlet",
    order: int = 2,
    boundary: Optional[Union[float, Callable]] = None,
    neumann=(),
    neumann_value: Union[float, Callable] = 0.0,
    device: Union[str, torch.device, None] = None,
) -> SolveResult:
    """Solve -lap(u) = forcing on the unit cube with Dirichlet boundaries,
    on ``device`` (the card when None).

    ``result.u`` is the (S, S, Sx) node grid, physical nodes at
    ``[0:n+1]`` on each axis; every level is padded to S = round_up(n+1,
    16), Sx = round_up(n+1, 128), the layout the 3D kernels take.
    ``boundary`` (a constant or ``g(x, y, z)``) lifts inhomogeneous face
    values.  ``order=4`` takes the compact 19-point Mehrstellen stencil and
    its smoothed right-hand side.  ``refined=True`` runs compensated
    double-single refinement: the f32 residual floor in 3D grows like
    eps n^2.  The default config is Chebyshev (3, 2), with the kernels on
    when the solve runs on the card.

    Not ported yet (each raises ``NotImplementedError``): ``mesh``,
    ``neumann``, ``bc="periodic"``, and a ``smooth_dtype`` other than
    ``dtype``.
    """
    device = default_device(device)
    config = _config3(config, finest_level, "chebyshev", device, nu1=3,
                      nu2=2)
    _check_single_device(config, mesh)
    if neumann:
        raise NotImplementedError("neumann faces (3D) are not ported yet")
    if order == 4:
        if bc != "dirichlet" or refined:
            raise ValueError("order=4 (3D) supports the Dirichlet unrefined "
                             "path")
        problem = Poisson4_3DProblem(config, forcing=forcing, device=device,
                                     **_pad_kw3(config))
        return _run(problem, config, tol, max_cycles, num_cycles, use_fmg,
                    boundary=boundary)
    if order != 2:
        raise ValueError(f"order must be 2 or 4, got {order}")
    if bc == "periodic":
        raise NotImplementedError('bc="periodic" (3D) is not ported yet')
    if bc != "dirichlet":
        raise ValueError(f'bc must be "dirichlet" or "periodic", got {bc!r}')
    problem = Poisson3DProblem(config, forcing=forcing, align=16,
                               min_pad_level=0, lane_align=128, device=device)
    return _run(problem, config, tol, max_cycles, num_cycles, use_fmg,
                refined=refined, boundary=boundary)


def solve_diffusion3d(
    finest_level: int = 6,
    *,
    coefficient: Union[float, Callable] = 1.0,
    shift: Union[float, Callable] = 0.0,
    config: Optional[MultigridConfig] = None,
    forcing: Union[float, Callable] = 6.0,
    tol: Optional[float] = 1e-8,
    max_cycles: int = 100,
    num_cycles: Optional[int] = None,
    use_fmg: bool = False,
    mesh=None,
    boundary: Optional[Union[float, Callable]] = None,
    device: Union[str, torch.device, None] = None,
) -> SolveResult:
    """Solve -div(a grad u) + shift u = forcing on the unit cube with
    per-cell coefficients ``a(x, y, z)``, on ``device`` (the card when
    None).  ``shift`` (a constant or ``c(x, y, z)``, positive-definite
    regime only) is re-discretized on every level; the coarse levels re-
    discretize from 2x2x2 cell averages.  Callables are evaluated on float64
    torch tensors.  ``boundary`` lifts inhomogeneous face values.  Levels
    are padded to S = round_up(n+1, 16), Sx = round_up(n+1, 128); wide
    level pairs run K1v_3 / K2v_3 (3 coefficient planes, 4 with ``shift``).
    The default config is Chebyshev (3, 2), with the kernels on when the
    solve runs on the card.  ``mesh`` raises ``NotImplementedError`` (not
    ported yet).
    """
    device = default_device(device)
    config = _config3(config, finest_level, "chebyshev", device, nu1=3,
                      nu2=2)
    _check_single_device(config, mesh)
    problem = Diffusion3DProblem(config, coefficient=coefficient, shift=shift,
                                 forcing=forcing, device=device)
    return _run(problem, config, tol, max_cycles, num_cycles, use_fmg,
                boundary=boundary)


def solve_convection_diffusion3d(
    finest_level: int = 5,
    *,
    eps: float = 1.0,
    bx: Union[float, Callable] = 0.0,
    by: Union[float, Callable] = 0.0,
    bz: Union[float, Callable] = 0.0,
    config: Optional[MultigridConfig] = None,
    forcing: Union[float, Callable] = 6.0,
    tol: Optional[float] = 1e-8,
    max_cycles: int = 100,
    num_cycles: Optional[int] = None,
    use_fmg: bool = False,
    boundary: Optional[Union[float, Callable]] = None,
    mesh=None,
    device: Union[str, torch.device, None] = None,
) -> SolveResult:
    """Solve -eps lap(u) + b . grad(u) = forcing on the unit cube (first-
    order upwind, nonsymmetric), on ``device`` (the card when None).  The
    winds ``bx``, ``by``, ``bz`` are constants or callables ``b(x, y, z)``,
    evaluated on float64 torch tensors.  The default config is RB-GS (1, 1),
    the robust smoother at high mesh Peclet number, with the kernels on when
    the solve runs on the card; the levels are padded for the kernels only
    when the config takes them.  Constant winds ride K1_3 / K2_3 through
    ``STENCIL27``, callable winds K1v_3 / K2v_3 (6 planes).  ``mesh`` raises
    ``NotImplementedError`` (not ported yet).
    """
    device = default_device(device)
    config = _config3(config, finest_level, "rbgs", device)
    _check_single_device(config, mesh)
    problem = ConvectionDiffusion3DProblem(config, eps=eps, bx=bx, by=by,
                                           bz=bz, forcing=forcing,
                                           device=device, **_pad_kw3(config))
    return _run(problem, config, tol, max_cycles, num_cycles, use_fmg,
                boundary=boundary)


def _config3(config: Optional[MultigridConfig], finest_level: int,
             smoother: str, device: torch.device, **kw) -> MultigridConfig:
    """A 3D front door's config: the given one at ``finest_level``, or its
    default schedule with the kernels on when the solve runs on the card."""
    if config is None:
        return MultigridConfig(finest_level=finest_level, smoother=smoother,
                               use_kernels=device.type == "cuda", **kw)
    return _level_config(config, finest_level)


def _pad_kw3(config: MultigridConfig) -> dict:
    """The 3D kernels' layout: (z, y) 16-aligned, x 128-aligned."""
    if config.use_kernels:
        return dict(align=16, min_pad_level=0, lane_align=128)
    return {}


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
        if getattr(op0, "ndim", 2) == 3:
            lift = boundary_grid3(op0.n, op0.grid_shape, boundary,
                                  config.dtype, b.device)
        else:
            lift = boundary_grid(op0.n, op0.S, boundary, config.dtype,
                                 b.device)
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
    """Crop the padded solve grid to the physical (n+1,)^d node grid."""
    return result_u[(slice(0, n + 1),) * result_u.ndim]
