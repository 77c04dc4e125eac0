"""FAS (Full Approximation Scheme) multigrid for nonlinear problems.

The counterpart of ``tpu_multigrid.cycles.fas``.  FAS carries the full
approximation to the coarse levels instead of the error:

    pre-smooth          u ← S(u, b)
    restrict            û = I u (literal injection),  r̂ = R (b − N(u))
    coarse equation     N_c(u_c) = N_c(û) + r̂, solved from u_c = û
    correct             u ← u + P (u_c − û)
    post-smooth         u ← S(u, b)

For a linear N this is the correction scheme shifted by û.  A level pair
the kernel gate admits (:func:`_use_fas_super_kernels`) runs its downward
half in K1f and its upward half in K2f (``kernels.fas`` in 2D,
``kernels.fas3d`` in 3D); the other pairs run the operators' plain torch
methods.  The until-tol driver takes its decisions in float32, as the JAX
driver does.

The drivers record ``tracing`` spans as the linear ones do: a ``solve``
root (also around :func:`fmg_fas` called alone), a ``cycle`` for each
finest-level cycle, a ``coarse`` around each coarsest-level solve, an
``fmg`` around FMG-FAS, and their blocking reads through ``tracing.sync``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import tracing
from ..config import MultigridConfig
from ..core import ops, ops3d
from ..core.grids import Hierarchy
from ..core.nonlinear import (CARRIED, PointwiseNonlinearOp,
                              QuasilinearFluxOp, QuasilinearFluxOp3,
                              inject_solution, inject_solution3, op_selector)
from ..core.operators import ConstStencilOp, ConstStencilOp3D
from ..kernels import fas as _kf
from ..kernels import fas3d as _kf3
from . import SolveResult


def _gshape(op):
    return getattr(op, "grid_shape", (op.S, op.S))


def _ndim(op) -> int:
    return getattr(op, "ndim", 2)


def _restrict_pair(op, opc, u, r):
    """(solution injection, residual restriction), 2D or 3D."""
    if _ndim(op) == 3:
        return (inject_solution3(u, op.n, _gshape(opc)),
                ops3d.restrict_fw3(r, op.n, _gshape(opc)))
    return inject_solution(u, op.n, opc.S), ops.restrict_fw(r, op.n, opc.S)


def _prolong_err(e, opc, op):
    if _ndim(op) == 3:
        return ops3d.prolong3(e, opc.n, _gshape(op))
    return ops.prolong(e, opc.n, op.S)


def _nsmooth(op, u, b, cfg: MultigridConfig, sweeps: int):
    return op.nsmooth(u, b, omega=cfg.omega, sweeps=sweeps)


def _family(op, opc):
    """"pointwise" or "quasilinear" when both levels are of one family the
    kernels take (pointwise over the constant 5- or 7-point stencil, or the
    2D / 3D flux operator), else None."""
    if _ndim(op) == 3:
        lin, flux = ConstStencilOp3D, QuasilinearFluxOp3
    else:
        lin, flux = ConstStencilOp, QuasilinearFluxOp
    if all(isinstance(o, PointwiseNonlinearOp) and isinstance(o.lin, lin)
           for o in (op, opc)):
        return "pointwise"
    if all(isinstance(o, flux) for o in (op, opc)):
        return "quasilinear"
    return None


def _use_fas_super_kernels(op, opc, cfg: MultigridConfig, dtype) -> bool:
    """Whether K1f/K2f cover this level pair: the kernels on, a family they
    take, and the geometry gate (``fas_supported`` / ``fas3_supported``,
    the JAX package's).  A pair of a family the kernels take whose
    nonlinearity is a caller's own callable raises ``ValueError`` with the
    kernels on: the kernels carry a closed set (``core.nonlinear.
    kernel_selector``), and such a solve is not run plain behind the
    caller's back."""
    if not cfg.use_kernels or _family(op, opc) is None:
        return False
    if op_selector(op) is None or op_selector(opc) is None:
        raise ValueError(f"use_kernels=True: the FAS kernels carry only "
                         f"{CARRIED}; this operator's nonlinearity is a "
                         f"caller's own callable (solve it with "
                         f"use_kernels=False)")
    steps = max(cfg.nu1, cfg.nu2)
    if _ndim(op) == 3:
        return _kf3.fas3_supported(op.grid_shape, opc.grid_shape, steps,
                                   dtype)
    return _kf.fas_supported(op.S, opc.S, steps, dtype)


def _pointwise_args(op):
    return (op.phi, op.dphi, float(op.h2), float(op.diag))


def _fused_fas_k1(op, opc, cfg: MultigridConfig, u, b):
    omega = float(cfg.omega)
    if _ndim(op) == 3:
        if isinstance(op, QuasilinearFluxOp3):
            return _kf3.qfas_smooth_restrict3(u, b, op.n, opc.grid_shape,
                                              cfg.nu1, omega, op.a)
        return _kf3.fas_smooth_restrict3(u, b, op.n, opc.grid_shape, cfg.nu1,
                                         omega, *_pointwise_args(op))
    if isinstance(op, QuasilinearFluxOp):
        return _kf.qfas_smooth_restrict(u, b, op.n, opc.S, cfg.nu1, omega,
                                        op.a)
    return _kf.fas_smooth_restrict(u, b, op.n, opc.S, cfg.nu1, omega,
                                   *_pointwise_args(op))


def _fused_fas_k2(op, cfg: MultigridConfig, u, b, ec, resnorm=False):
    """K2f on the level, or K2f-resnorm with ``resnorm``: (u', norm)."""
    omega = float(cfg.omega)
    mod, suffix = (_kf3, "3") if _ndim(op) == 3 else (_kf, "")
    quasi = isinstance(op, (QuasilinearFluxOp, QuasilinearFluxOp3))
    name = (("qfas_" if quasi else "fas_") + "prolong_smooth"
            + ("_resnorm" if resnorm else "") + suffix)
    args = (op.a,) if quasi else _pointwise_args(op)
    return getattr(mod, name)(u, b, ec, op.n, cfg.nu2, omega, *args)


def _coarsest(hier: Hierarchy, cfg: MultigridConfig, u, b):
    """The coarsest level's solve, in a ``coarse`` span: the dense Newton
    solve (``kind="newton"``) or Jacobi-Newton / Picard sweeps
    (``"smooth"``)."""
    op = hier.levels[-1]
    if cfg.coarse_solver == "direct" and getattr(op, "a_dense",
                                                 None) is not None:
        with tracing.span("coarse", u, kind="newton"):
            return op.coarse_newton(u, b, steps=3)
    with tracing.span("coarse", u, kind="smooth"):
        return _nsmooth(op, u, b, cfg, cfg.coarse_smooth_sweeps)


def fas_cycle(hier: Hierarchy, cfg: MultigridConfig, u, b, k: int = 0):
    """One FAS cycle (V, W or F per ``cfg.cycle``) at level index k."""
    if k == hier.num_levels - 1:
        return _coarsest(hier, cfg, u, b)

    op = hier.levels[k]
    opc = hier.levels[k + 1]
    fused = _use_fas_super_kernels(op, opc, cfg, u.dtype)
    if fused:
        u, uc0, bc = _fused_fas_k1(op, opc, cfg, u, b)
    else:
        u = _nsmooth(op, u, b, cfg, cfg.nu1)
        r = op.residual(u, b)
        uc0, rc = _restrict_pair(op, opc, u, r)
        bc = opc.apply(uc0) + rc

    uc = _coarse_visits(hier, cfg, uc0, bc, k + 1)
    if fused:
        return _fused_fas_k2(op, cfg, u, b, uc - uc0)
    u = u + _prolong_err(uc - uc0, opc, op)
    return _nsmooth(op, u, b, cfg, cfg.nu2)


def _coarse_visits(hier, cfg, uc, bc, k):
    """The coarse-level cycles of a V, W or F cycle, from uc."""
    uc = fas_cycle(hier, cfg, uc, bc, k)
    if cfg.cycle == "W":
        uc = fas_cycle(hier, cfg, uc, bc, k)
    elif cfg.cycle == "F":
        uc = fas_cycle(hier, dataclasses.replace(cfg, cycle="V"), uc, bc, k)
    return uc


def fas_cycle_with_norm(hier: Hierarchy, cfg: MultigridConfig, u, b):
    """One finest-level FAS cycle and the post-cycle nonlinear residual norm
    (0-d float32).  On the kernel path the norm rides the finest K2f;
    otherwise it is one residual and norm pass."""
    op = hier.levels[0]
    if hier.num_levels == 1:
        u = _coarsest(hier, cfg, u, b)
        return u, ops.norm2(op.residual(u, b))
    opc = hier.levels[1]
    if _use_fas_super_kernels(op, opc, cfg, u.dtype):
        u, uc0, bc = _fused_fas_k1(op, opc, cfg, u, b)
        uc = _coarse_visits(hier, cfg, uc0, bc, 1)
        return _fused_fas_k2(op, cfg, u, b, uc - uc0, resnorm=True)
    u = fas_cycle(hier, cfg, u, b)
    return u, ops.norm2(op.residual(u, b))


def fas_solve_fixed(hier: Hierarchy, cfg: MultigridConfig, b,
                    num_cycles: int, u0=None) -> SolveResult:
    """Run exactly ``num_cycles`` FAS cycles, recording the nonlinear
    residual norms."""
    with tracing.solve() as root:
        op = hier.levels[0]
        u = u0 if u0 is not None else b.new_zeros(_gshape(op))
        hist = torch.full((num_cycles + 1,), float("nan"),
                          dtype=torch.float32, device=b.device)
        hist[0] = ops.norm2(op.residual(u, b))
        for i in range(num_cycles):
            with tracing.span("cycle", b):
                u, rnorm = fas_cycle_with_norm(hier, cfg, u, b)
            hist[i + 1] = rnorm
        root.set(iterations=num_cycles)
        return SolveResult(u=u, res_history=tracing.sync(hist, "history"),
                           iterations=num_cycles, converged=True)


def fas_solve_until_tol(hier: Hierarchy, cfg: MultigridConfig, b, *,
                        tol: float, max_cycles: int = 100,
                        relative: bool = True, u0=None,
                        stall_factor: float = 0.9) -> SolveResult:
    """FAS cycles until the nonlinear residual drops below ``tol``
    (relative to the initial one by default), stalls (two consecutive
    cycles each reducing it by less than ``stall_factor``), or
    ``max_cycles`` is hit."""
    with tracing.solve() as root:
        op = hier.levels[0]
        u = u0 if u0 is not None else b.new_zeros(_gshape(op))
        r0 = np.float32(tracing.sync(ops.norm2(op.residual(u, b)), "norm"))
        target = np.float32(tol) * r0 if relative else np.float32(tol)
        target = max(target, np.float32(0.0))
        sf = np.float32(stall_factor)
        hist = np.full((max_cycles + 1,), np.nan, np.float32)
        hist[0] = r0
        i, rnorm, stalls = 0, r0, 0
        while i < max_cycles and rnorm > target and stalls < 2:
            with tracing.span("cycle", b):
                u, rnew_t = fas_cycle_with_norm(hier, cfg, u, b)
            rnew = np.float32(tracing.sync(rnew_t, "norm"))
            hist[i + 1] = rnew
            stalls = stalls + 1 if rnew > sf * rnorm else 0
            rnorm = rnew
            i += 1
        root.set(iterations=i)
        return SolveResult(u=u, res_history=torch.from_numpy(hist),
                           iterations=i, converged=bool(rnorm <= target))


def fmg_fas(hier: Hierarchy, cfg: MultigridConfig, b_levels):
    """FMG-FAS (nested iteration): the coarsest nonlinear solve, then per
    level prolong the solution and run ``cfg.nu0`` FAS cycles against that
    level's own assembled right-hand side (``problem.rhs_all_levels()``).
    A ``solve`` root (``iterations``: the FAS cycles run) when called
    outside another driver's, and an ``fmg`` span."""
    kc = hier.num_levels - 1
    with tracing.solve() as root, tracing.span("fmg", b_levels[0]):
        u = b_levels[0].new_zeros(_gshape(hier.levels[kc]))
        u = _coarsest(hier, cfg, u, b_levels[kc])
        for k in range(kc - 1, -1, -1):
            u = _prolong_err(u, hier.levels[k + 1], hier.levels[k])
            for _ in range(cfg.nu0):
                u = fas_cycle(hier, cfg, u, b_levels[k], k)
        root.set(iterations=kc * cfg.nu0)
        return u
