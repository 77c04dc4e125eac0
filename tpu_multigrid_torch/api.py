"""Front-door solve API: single-device Dirichlet solves of Poisson (2D and
3D: ``solve_poisson``, ``solve_poisson3d``), variable-coefficient diffusion
(``solve_diffusion``, ``solve_diffusion3d``), shifted Poisson
(``solve_helmholtz``), anisotropic Poisson (``solve_anisotropic``) and 3D
convection-diffusion (``solve_convection_diffusion3d``) problems, and the
nonlinear FAS solves (``solve_nonlinear_poisson``, ``solve_bratu``,
``solve_quasilinear_diffusion``, 2D and 3D).

Both Poisson doors also solve on the periodic torus (``bc="periodic"``).
Every entry runs on ``device``; ``device=None`` means the card
(``config.default_device``), and raises where there is none.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Optional, Union

import torch

from . import tracing
from .config import MultigridConfig, default_device
from .core.nonlinear import CARRIED, BratuNonlinearity, kernel_selector
from .cycles import SolveResult, fmg, solve_fixed, solve_until_tol
from .cycles.fas import fas_solve_fixed, fas_solve_until_tol, fmg_fas
from .dist.fas_pallas import fas_sharded_solve_pallas
from .problems.anisotropic import AnisotropicPoissonProblem
from .problems.bratu import (Bratu3DProblem, BratuProblem,
                             NonlinearPoisson3DProblem, NonlinearPoissonProblem)
from .problems.convection3d import ConvectionDiffusion3DProblem
from .problems.diffusion import DiffusionProblem
from .problems.diffusion3d import Diffusion3DProblem
from .problems.helmholtz import HelmholtzProblem
from .problems.nldiffusion import (QuasilinearDiffusion3DProblem,
                                   QuasilinearDiffusionProblem)
from .problems.periodic import PeriodicPoissonProblem
from .problems.periodic3d import Periodic3DPoissonProblem
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
    u0=None,
    dist_path: str = "jnp",
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

    ``bc="periodic"`` solves on the unit torus: ``forcing`` must be a
    zero-mean callable, ``result.u`` is the (n, n) grid of the unique nodes
    in its mean-zero gauge (:func:`extract_solution` closes it), and
    ``boundary``, ``refined`` and ``order=4`` raise ``ValueError``.  With
    ``use_kernels`` on float32 and ``tol`` or ``num_cycles`` given, the
    levels whose n is a multiple of 256 run the fused tier on K1-local and
    K2-local (``cycles.periodic_fused``); the rest, and an FMG start, run
    the plain torus operators.

    ``mesh`` (a :class:`tpu_multigrid_torch.dist.GridMesh`, every rank
    calling) solves on a grid of ranks, on the mesh's device, through
    ``dist_path="pallas"``: the fused tier (``dist.sharded_solve_pallas``),
    or with ``refined`` its compensated refinement
    (``dist.refined_sharded_solve_pallas``, a double-single pair), with the
    same automatic choice of ``refined`` as above.  ``result.u`` is then
    this rank's owned block (``dist.gather_full`` assembles the global
    (S0, S0) grid), and ``u0`` a starting iterate on that global grid.
    ``u0`` is taken only with ``mesh``.

    Not ported yet (each raises ``NotImplementedError``): ``neumann``,
    ``order=4``, a ``smooth_dtype`` other than ``dtype``, and with ``mesh``
    ``dist_path="jnp"`` (the default: the plain shard-local tier) and
    ``bc="periodic"``.
    """
    config = _level_config(config, finest_level)
    if mesh is not None:
        return _solve_on_mesh(config, mesh, forcing, boundary, tol,
                              max_cycles, num_cycles, use_fmg, refined,
                              neumann, u0, dist_path, order, bc, device)
    _check_single_device(config, mesh)
    if u0 is not None:
        raise ValueError("u0 is taken only with mesh= (distributed solves); "
                         "the single-device solve starts from zero or from "
                         "use_fmg")
    if neumann:
        raise NotImplementedError("neumann sides are not ported yet")
    if bc == "periodic":
        return _solve_periodic(config, forcing, boundary, refined, order, tol,
                               max_cycles, num_cycles, use_fmg, device)
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


_DIST_QUEUE = "ROADMAP.md, queue 1 item 16"


def _solve_on_mesh(config, mesh, forcing, boundary, tol, max_cycles,
                   num_cycles, use_fmg, refined, neumann, u0, dist_path,
                   order, bc, device) -> SolveResult:
    """``solve_poisson(mesh=...)``: the constant-coefficient Dirichlet
    order-2 problem on the fused tier."""
    from .dist import refined_sharded_solve_pallas, sharded_solve_pallas
    _check_single_device(config, None)
    if bc == "periodic":
        raise NotImplementedError("bc='periodic' with mesh= (dist/periodic"
                                  f") is not ported yet ({_DIST_QUEUE})")
    if bc != "dirichlet":
        raise ValueError(f'bc must be "dirichlet" or "periodic", got {bc!r}')
    if neumann:
        raise NotImplementedError("neumann sides with mesh= are not ported "
                                  f"yet ({_DIST_QUEUE})")
    if order == 4:
        raise NotImplementedError("order=4 with mesh= is not ported yet "
                                  f"({_DIST_QUEUE})")
    if order != 2:
        raise ValueError(f"order must be 2 or 4, got {order}")
    if dist_path == "jnp":
        raise NotImplementedError('dist_path="jnp" (the plain shard-local '
                                  "tier, dist/shard_cycle.sharded_solve) is "
                                  f'not ported yet ({_DIST_QUEUE}); pass '
                                  'dist_path="pallas"')
    if dist_path != "pallas":
        raise ValueError(f'dist_path must be "jnp" or "pallas", got '
                         f"{dist_path!r}")
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's device "
                         f"{mesh.device}")
    if boundary is not None:
        raise ValueError("mesh= does not support boundary lifting yet; "
                         "use the single-device path")
    if tol is None and num_cycles is None:
        raise ValueError("need either tol or num_cycles (both are None)")
    if refined is None:
        refined = (tol is not None and tol < 1e-5
                   and config.dtype == torch.float32)
    if refined:
        if use_fmg:
            raise ValueError("mesh= refined=True does not take use_fmg "
                             "yet (seed via u0= instead)")
        if u0 is not None:
            raise ValueError('dist_path="pallas" refined does not take u0 '
                             "yet")
        res, _ = refined_sharded_solve_pallas(
            config, mesh, forcing=forcing, tol=tol, max_iters=max_cycles,
            num_cycles=num_cycles)
        return res
    res, _ = sharded_solve_pallas(
        config, mesh, forcing=forcing, u0=u0, use_fmg=use_fmg,
        tol=tol if tol is not None else 0.0, max_cycles=max_cycles,
        num_cycles=num_cycles)
    return res


def _solve_periodic(config, forcing, boundary, refined, order, tol,
                    max_cycles, num_cycles, use_fmg, device) -> SolveResult:
    """``solve_poisson(bc="periodic")``: the fused tier where its gate takes
    the finest level, else the protocol path."""
    from .cycles.periodic_fused import (fused_levels, solve_fixed_periodic,
                                        solve_until_tol_periodic)
    if boundary is not None or refined or order != 2:
        raise ValueError("bc='periodic' is incompatible with "
                         "boundary/neumann/refined/order options")
    problem = PeriodicPoissonProblem(config, forcing=forcing, device=device)
    hier = problem.hierarchy
    if (tol is None and num_cycles is None) or fused_levels(
            hier, config, config.dtype) == 0:
        return _run(problem, config, tol, max_cycles, num_cycles, use_fmg)
    b = problem.rhs()
    with tracing.solve() as root:
        u0 = fmg(hier, config, b) if use_fmg else None
        if num_cycles is not None:
            res = solve_fixed_periodic(hier, config, b, num_cycles, u0=u0)
        else:
            res = solve_until_tol_periodic(hier, config, b, tol=tol,
                                           max_cycles=max_cycles, u0=u0)
        root.set(iterations=res.iterations)
    return res


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


def solve_anisotropic(
    finest_level: int = 10,
    *,
    eps_x: float = 1.0,
    eps_y: float = 1.0,
    angle: float = 0.0,
    coarsening: str = "auto",
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
    """Solve -div(K grad u) = forcing with the constant tensor ``K =
    R(angle) diag(eps_x, eps_y) R(angle)^T`` (``angle = 0``: -(eps_x u_xx +
    eps_y u_yy)) on ``device`` (the card when None).

    ``coarsening="full"`` is the standard hierarchy with Galerkin coarse
    operators, robust at strong anisotropy with ``config.smoother=
    "zebra_x"`` (eps_x >> eps_y) or ``"zebra_y"``.  ``"auto"`` resolves as
    in the JAX package: semi-coarsening when the anisotropy exceeds 4:1, the
    grid is not rotated and no zebra smoother is configured, full otherwise.
    With the kernels on, ``zebra_y`` solves the transposed problem with
    ``zebra_x`` (the same eps, ``angle' = pi/2 - angle``, forcing and
    boundary with swapped arguments) and transposes back, as the JAX
    package does.  ``boundary`` lifts inhomogeneous Dirichlet values.  The
    default config is the other 2D doors' (kernels off).

    Not ported yet (each raises ``NotImplementedError``): semi-coarsening
    (``coarsening="semi"``, or ``"auto"`` resolving to it), ``mesh``, and a
    ``smooth_dtype`` other than ``dtype``.
    """
    config = _level_config(config, finest_level)
    _check_single_device(config, mesh)
    if coarsening == "auto":
        ratio = max(eps_x, eps_y) / max(min(eps_x, eps_y), 1e-300)
        zebra = config.smoother in ("zebra_x", "zebra_y")
        coarsening = "semi" if (ratio > 4.0 and not zebra
                                and angle == 0.0) else "full"
    transpose = (coarsening == "full" and config.smoother == "zebra_y"
                 and config.use_kernels)
    if transpose:
        # The zebra kernels take lines along x only: transposing the grid
        # maps K to P K P^T, which is the same (eps_x, eps_y) at angle
        # pi/2 - angle; the forcing and boundary swap their arguments.
        config = dataclasses.replace(config, smoother="zebra_x")
        angle = math.pi / 2 - angle
        forcing = _swap_args(forcing)
        boundary = _swap_args(boundary)
    problem = AnisotropicPoissonProblem(config, eps_x=eps_x, eps_y=eps_y,
                                        forcing=forcing,
                                        coarsening=coarsening, angle=angle,
                                        device=device, **_pad_kw(config))
    res = _run(problem, config, tol, max_cycles, num_cycles, use_fmg,
               boundary=boundary)
    if transpose:
        res = dataclasses.replace(res, u=res.u.T.contiguous())
    return res


def _swap_args(field):
    """f(y, x) for a callable field f(x, y); a constant as it is."""
    if callable(field):
        return lambda x, y: field(y, x)
    return field


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
    when the solve runs on the card.  ``bc="periodic"`` solves on the unit
    3-torus (a zero-mean callable ``forcing``; ``result.u`` is the (n, n,
    n) grid of the unique nodes, mean-zero) on the plain torus operators,
    whatever the config's ``use_kernels``; ``refined`` and ``boundary``
    raise ``ValueError`` there.

    Not ported yet (each raises ``NotImplementedError``): ``mesh``,
    ``neumann``, and a ``smooth_dtype`` other than ``dtype``.
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
        if refined or boundary is not None:
            raise ValueError("bc='periodic' (3D) supports the unrefined "
                             "path (and has no boundary)")
        pcfg = dataclasses.replace(config, use_kernels=False)
        problem = Periodic3DPoissonProblem(pcfg, forcing=forcing,
                                           device=device)
        return _run(problem, pcfg, tol, max_cycles, num_cycles, use_fmg)
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
    refined: bool = False,
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
    ``refined=True`` runs compensated double-single refinement
    (``precision.solve_refined``), its residual evaluated in float64 on the
    operator's float32 transmissibilities: the f32 residual floor stalls
    the plain iterate near 3e-3 of ||b|| at 513^3; ``result.u`` is the
    high part of the pair.  The default config is Chebyshev (3, 2), with
    the kernels on when the solve runs on the card.  ``mesh`` raises
    ``NotImplementedError`` (not ported yet).
    """
    device = default_device(device)
    config = _config3(config, finest_level, "chebyshev", device, nu1=3,
                      nu2=2)
    _check_single_device(config, mesh)
    problem = Diffusion3DProblem(config, coefficient=coefficient, shift=shift,
                                 forcing=forcing, device=device)
    return _run(problem, config, tol, max_cycles, num_cycles, use_fmg,
                refined=refined, boundary=boundary)


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
        raise NotImplementedError("distributed solves (mesh=) of this door "
                                  f"are not ported yet ({_DIST_QUEUE})")
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
    with tracing.solve() as root:
        u0 = fmg(hier, config, b) if use_fmg else None
        if refined:
            from .precision import solve_refined
            res = solve_refined(hier, config, b, tol=tol,
                                max_iters=max_cycles, num_cycles=num_cycles,
                                u0=u0)
        elif num_cycles is not None:
            res = solve_fixed(hier, config, b, num_cycles, u0=u0)
        else:
            res = solve_until_tol(hier, config, b, tol=tol,
                                  max_cycles=max_cycles, u0=u0)
        root.set(iterations=res.iterations)
    if lift is not None:
        res = dataclasses.replace(res, u=res.u + lift)
    return res


# ---------------------------------------------------------------------------
# Nonlinear solves (FAS multigrid; cycles/fas.py)
# ---------------------------------------------------------------------------

def _run_fas(problem, config: MultigridConfig, tol, max_cycles, num_cycles,
             use_fmg) -> SolveResult:
    """FAS analogue of :func:`_run`: nonlinear residual norms; FMG-FAS
    prolongs the solution and takes the per-level assembled right-hand
    sides."""
    if tol is None and num_cycles is None:
        raise ValueError("need either tol or num_cycles (both are None)")
    if config.smoother != "jacobi":
        # FAS smooths with Jacobi-Newton / Picard-Jacobi (op.nsmooth); a
        # smoother chosen for the linear tier would not apply.
        warnings.warn(
            f"FAS solvers smooth with weighted Jacobi-Newton/Picard only; "
            f"config.smoother={config.smoother!r} is ignored",
            stacklevel=3)
    hier = problem.hierarchy
    bs = problem.rhs_all_levels() if use_fmg else [problem.rhs()]
    with tracing.solve() as root:
        u0 = fmg_fas(hier, config, bs) if use_fmg else None
        if num_cycles is not None:
            res = fas_solve_fixed(hier, config, bs[0], num_cycles, u0=u0)
        else:
            res = fas_solve_until_tol(hier, config, bs[0], tol=tol,
                                      max_cycles=max_cycles, u0=u0)
        root.set(iterations=res.iterations)
    return res


def _fas_config(config: Optional[MultigridConfig], finest_level: int,
                device: torch.device, carried: bool, mesh, dist_path: str,
                ndim: int, **defaults) -> MultigridConfig:
    """A FAS door's config: the given one at ``finest_level``, or the
    default schedule (with ``defaults``) with the kernels on when the solve
    runs on the card and the nonlinearity is one the kernels carry.  Raises
    for what is not ported and for ``use_kernels=True`` with a caller's own
    nonlinearity."""
    if ndim not in (2, 3):
        raise ValueError(f"ndim must be 2 or 3, got {ndim}")
    if dist_path != "jnp":
        raise NotImplementedError(f"dist_path={dist_path!r} without mesh= "
                                  "is not ported (it selects a distributed "
                                  "FAS path; pass mesh=)")
    if config is None:
        config = MultigridConfig(finest_level=finest_level,
                                 use_kernels=device.type == "cuda" and carried,
                                 **defaults)
    config = _level_config(config, finest_level)
    _check_single_device(config, mesh)
    if config.use_kernels and not carried:
        raise ValueError(f"use_kernels=True: the FAS kernels carry only "
                         f"{CARRIED}; a caller's own nonlinearity runs on the "
                         f"plain path (use_kernels=False)")
    return config


def _fas_mesh_config(config: Optional[MultigridConfig], finest_level: int,
                     mesh, dist_path: str, ndim: int, use_fmg: bool, device,
                     **defaults) -> MultigridConfig:
    """A FAS door's config on its ``mesh=`` route (the fused distributed
    tier, ``dist.fas_sharded_solve_pallas``, in 2D with
    ``dist_path="pallas"``): the given one at ``finest_level``, or the
    default schedule with ``defaults``.  Raises for what is not ported and
    for what the route does not take."""
    if ndim not in (2, 3):
        raise ValueError(f"ndim must be 2 or 3, got {ndim}")
    if dist_path == "jnp":
        raise NotImplementedError('dist_path="jnp" (the plain shard-local FAS'
                                  " tier, dist/fas.fas_sharded_solve) is not "
                                  f'ported yet ({_DIST_QUEUE}); pass '
                                  'dist_path="pallas"')
    if dist_path != "pallas":
        raise ValueError(f'dist_path must be "jnp" or "pallas", got '
                         f"{dist_path!r}")
    if ndim == 3:
        raise NotImplementedError("ndim=3 with mesh= (the GSPMD FAS route) is "
                                  f"not ported yet ({_DIST_QUEUE})")
    if use_fmg:
        raise ValueError("mesh= FAS does not support FMG yet (use the "
                         "single-device path)")
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's device "
                         f"{mesh.device}")
    if config is None:
        config = MultigridConfig(finest_level=finest_level, **defaults)
    config = _level_config(config, finest_level)
    _check_single_device(config, None)
    return config


def _fas_pad(config: MultigridConfig, ndim: int) -> dict:
    return _pad_kw3(config) if ndim == 3 else _pad_kw(config)


def solve_nonlinear_poisson(
    finest_level: int = 8,
    *,
    phi: Callable,
    dphi: Callable,
    ndim: int = 2,
    config: Optional[MultigridConfig] = None,
    forcing: Union[float, Callable, None] = None,
    tol: Optional[float] = 1e-8,
    max_cycles: int = 100,
    num_cycles: Optional[int] = None,
    use_fmg: bool = False,
    mesh=None,
    dist_path: str = "jnp",
    device: Union[str, torch.device, None] = None,
) -> SolveResult:
    """Solve -lap(u) + phi(u) = forcing by FAS multigrid (2D, or 3D with
    ``ndim=3``), on ``device`` (the card when None).

    ``phi``/``dphi`` are pointwise callables on tensors (the nonlinearity
    and its derivative).  The CUDA kernels carry only the Bratu
    nonlinearity (``core.nonlinear.BratuNonlinearity`` passed as both
    ``phi`` and ``dphi``; see ``core.nonlinear.kernel_selector``); any
    other callable runs the plain torch path, which ``config=None`` picks
    for it, and a config that asks for ``use_kernels=True`` raises
    ``ValueError``.  ``use_fmg=True`` runs one FMG-FAS pass first.  Default
    forcing: 4 (2D) / 6 (3D).

    ``mesh`` (a :class:`tpu_multigrid_torch.dist.GridMesh`, every rank
    calling) with ``dist_path="pallas"`` solves in 2D on a grid of ranks,
    on the mesh's device, through K1f-local and K2f-local
    (``dist.fas_sharded_solve_pallas``): ``result.u`` is this rank's owned
    block.  On the card that route takes only a carried ``phi``, and with
    any callable it needs a Jacobi config and no ``use_fmg``
    (``ValueError``).

    Not ported yet (each raises ``NotImplementedError``): with ``mesh``,
    ``dist_path="jnp"`` (the default) and ``ndim=3``; ``dist_path`` other
    than ``"jnp"`` without ``mesh``.
    """
    if mesh is not None:
        config = _fas_mesh_config(config, finest_level, mesh, dist_path,
                                  ndim, use_fmg, device)
        return fas_sharded_solve_pallas(
            config, mesh, phi=phi, dphi=dphi,
            forcing=4.0 if forcing is None else forcing, tol=tol,
            max_cycles=max_cycles, num_cycles=num_cycles)[0]
    device = default_device(device)
    carried = kernel_selector(phi, dphi) is not None
    config = _fas_config(config, finest_level, device, carried, mesh,
                         dist_path, ndim)
    if forcing is None:
        forcing = 4.0 if ndim == 2 else 6.0
    cls = NonlinearPoisson3DProblem if ndim == 3 else NonlinearPoissonProblem
    problem = cls(config, phi=phi, dphi=dphi, forcing=forcing, device=device,
                  **_fas_pad(config, ndim))
    return _run_fas(problem, config, tol, max_cycles, num_cycles, use_fmg)


def solve_bratu(
    finest_level: int = 8,
    *,
    lam: float = 1.0,
    ndim: int = 2,
    config: Optional[MultigridConfig] = None,
    forcing: Union[float, Callable] = 0.0,
    tol: Optional[float] = 1e-8,
    max_cycles: int = 100,
    num_cycles: Optional[int] = None,
    use_fmg: bool = False,
    mesh=None,
    dist_path: str = "jnp",
    device: Union[str, torch.device, None] = None,
) -> SolveResult:
    """Solve the Bratu problem -lap(u) - lam * exp(u) = forcing by FAS
    multigrid, on ``device`` (the card when None).

    Converges to the lower solution branch for lam below the critical value
    (~6.81 on the unit square, ~9.9 on the unit cube with ``ndim=3``).  The
    default config is Jacobi-Newton (2, 2), coarsest level 3 with a dense
    Newton solve, with the K1f/K2f kernels on when the solve runs on the card
    (the JAX package's default leaves its Pallas kernels off).  ``mesh``
    with ``dist_path="pallas"`` solves in 2D on a grid of ranks, as
    :func:`solve_nonlinear_poisson` describes; the rest of ``mesh`` and
    ``dist_path`` raise ``NotImplementedError`` (not ported yet).
    """
    if mesh is not None:
        config = _fas_mesh_config(config, finest_level, mesh, dist_path,
                                  ndim, use_fmg, device)
        phi = BratuNonlinearity(lam)
        return fas_sharded_solve_pallas(
            config, mesh, phi=phi, dphi=phi, forcing=forcing, tol=tol,
            max_cycles=max_cycles, num_cycles=num_cycles)[0]
    device = default_device(device)
    config = _fas_config(config, finest_level, device, True, mesh, dist_path,
                         ndim)
    cls = Bratu3DProblem if ndim == 3 else BratuProblem
    problem = cls(config, lam=lam, forcing=forcing, device=device,
                  **_fas_pad(config, ndim))
    return _run_fas(problem, config, tol, max_cycles, num_cycles, use_fmg)


def solve_quasilinear_diffusion(
    finest_level: int = 8,
    *,
    gamma: float = 1.0,
    a: Optional[Callable] = None,
    da: Optional[Callable] = None,
    ndim: int = 2,
    config: Optional[MultigridConfig] = None,
    forcing: Union[float, Callable, None] = None,
    tol: Optional[float] = 1e-8,
    max_cycles: int = 100,
    num_cycles: Optional[int] = None,
    use_fmg: bool = False,
    mesh=None,
    dist_path: str = "jnp",
    device: Union[str, torch.device, None] = None,
) -> SolveResult:
    """Solve -div(a(u) grad u) = forcing by FAS multigrid (2D or 3D), on
    ``device`` (the card when None).

    Default a(u) = 1 + gamma * u^2 (``core.nonlinear.QuadraticCoefficient``,
    which the CUDA kernels carry); a caller's own positive ``a`` runs the
    plain path (``da`` is accepted for API symmetry), and raises
    ``ValueError`` with a config that asks for ``use_kernels=True``.
    Matrix-free flux operator with Picard-Jacobi smoothing.  The default
    config smooths the coarsest level with 40 Picard sweeps
    (``coarse_solver="smooth"``), with the kernels on when the solve runs on
    the card and the coefficient is carried.  Default forcing: 4 (2D) / 6
    (3D).  ``mesh`` with ``dist_path="pallas"`` solves in 2D on a grid of
    ranks, as :func:`solve_nonlinear_poisson` describes (on the card with
    the carried coefficient only); the rest of ``mesh`` and ``dist_path``
    raise ``NotImplementedError`` (not ported yet).
    """
    if mesh is not None:
        config = _fas_mesh_config(config, finest_level, mesh, dist_path,
                                  ndim, use_fmg, device,
                                  coarse_solver="smooth",
                                  coarse_smooth_sweeps=40)
        forcing = 4.0 if forcing is None else forcing
        problem = QuasilinearDiffusionProblem(
            config, gamma=gamma, a=a, da=da, forcing=forcing,
            device=mesh.device)
        return fas_sharded_solve_pallas(
            config, mesh, a=problem.a, forcing=forcing, tol=tol,
            max_cycles=max_cycles, num_cycles=num_cycles)[0]
    device = default_device(device)
    carried = a is None or kernel_selector(a) is not None
    config = _fas_config(config, finest_level, device, carried, mesh,
                         dist_path, ndim, coarse_solver="smooth",
                         coarse_smooth_sweeps=40)
    if forcing is None:
        forcing = 4.0 if ndim == 2 else 6.0
    cls = (QuasilinearDiffusion3DProblem if ndim == 3
           else QuasilinearDiffusionProblem)
    problem = cls(config, gamma=gamma, a=a, da=da, forcing=forcing,
                  device=device, **_fas_pad(config, ndim))
    return _run_fas(problem, config, tol, max_cycles, num_cycles, use_fmg)


def extract_solution(result_u: torch.Tensor, n: int) -> torch.Tensor:
    """Crop the padded solve grid to the physical (n+1,)^d node grid.

    A periodic result (``bc="periodic"``) is the (n,)^d grid of the unique
    torus nodes: the closing row and column (node n is node 0) are appended
    by wrap, so it comes out as the same (n+1,)^d closed node grid as the
    Dirichlet results."""
    if result_u.shape[-1] == n:
        for ax in range(result_u.ndim):
            result_u = torch.cat([result_u, result_u.narrow(ax, 0, 1)], ax)
        return result_u
    return result_u[(slice(0, n + 1),) * result_u.ndim]
