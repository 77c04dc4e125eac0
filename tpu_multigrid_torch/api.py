"""Front-door solve API: the single-device Dirichlet order-2 Poisson path."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from .config import MultigridConfig
from .cycles import SolveResult, fmg, solve_fixed, solve_until_tol
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
    """Solve -lap(u) = forcing on the unit square, on ``device``.

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
    if config is None:
        config = MultigridConfig(finest_level=finest_level)
    elif config.finest_level != finest_level:
        config = dataclasses.replace(config, finest_level=finest_level)
    if mesh is not None:
        raise NotImplementedError("distributed solves (mesh=) are not "
                                  "ported yet")
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
    if config.effective_smooth_dtype != config.dtype:
        raise NotImplementedError("smooth_dtype other than dtype (the delta "
                                  "form) is not ported yet")
    if refined is None:
        # A tol below the f32 residual floor cannot converge in the plain
        # f32 iterate: route it through compensated refinement.
        refined = (tol is not None and tol < 1e-5
                   and config.dtype == torch.float32)
    problem = PoissonProblem(config, forcing=forcing, device=device,
                             **_pad_kw(config))
    return _run(problem, config, tol, max_cycles, num_cycles, use_fmg,
                refined=refined, boundary=boundary)


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
