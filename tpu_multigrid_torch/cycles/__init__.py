"""Cycle orchestration: V / W / F cycles, FMG, and convergence-driven solves.

The recursion walks the hierarchy in Python.  With ``use_kernels`` a level
visit whose level pair passes :func:`_use_super_kernels` is two kernel
launches, K1 (smooth + residual + restrict) and K2 (prolong + correct +
smooth, with the residual norm fused into the finest level's K2 in
:func:`cycle_with_norm`); other levels run the plain torch operators.  Only
the constant-coefficient 2D branch of ``tpu_multigrid.cycles`` is here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ..config import MultigridConfig
from ..core import ops
from ..core.grids import Hierarchy, coarse_solve
from ..core.operators import ConstStencilOp
from ..kernels import transfer as _t

# Gate of the TPU streaming-smoother kernel (tpu_multigrid/kernels/
# stencil.py::supported): where the JAX package runs that kernel, this
# package raises until it is ported, rather than run plain torch unasked.
_STENCIL_TILE_C, _STENCIL_COL_HALO = 1024, 128


def _stencil_kernel_level(S: int, dtype, steps: int) -> bool:
    if dtype not in (torch.float32, torch.bfloat16):
        return False
    if not (S >= 256 and S % 128 == 0):
        return False
    q = 16 if dtype == torch.bfloat16 else 8
    hr = ((max(steps, 1) + q - 1) // q) * q
    if S - 2 * hr < q:
        return False
    return not (S >= _STENCIL_TILE_C + 2 * _STENCIL_COL_HALO
                and steps > _STENCIL_COL_HALO)


def _no_stencil_kernel(cfg: MultigridConfig, op, dtype, steps: int) -> None:
    if (cfg.use_kernels and isinstance(op, ConstStencilOp)
            and _stencil_kernel_level(op.S, dtype, steps)):
        raise NotImplementedError(
            "unfused smoothing/residual with use_kernels=True waits for the "
            "port of tpu_multigrid/kernels/stencil.py::_streamed")


# ---------------------------------------------------------------------------
# Smoothing with optional mixed precision
# ---------------------------------------------------------------------------

def _sm(cfg: MultigridConfig, sweeps: int):
    """Resolve the configured smoother to (kernel_name, omega):
    ``"chebyshev"`` is weighted Jacobi with the degree-``sweeps`` Chebyshev
    weight schedule as a tuple ``omega``."""
    if cfg.smoother == "chebyshev":
        return "jacobi", ops.chebyshev_omegas(max(sweeps, 1), cfg.cheb_lo)
    return cfg.smoother, cfg.omega


def _smooth(op, u, b, cfg: MultigridConfig, sweeps: int):
    """Smooth, optionally running the sweeps in a lower precision on the
    defect equation: d = b - A u in full precision, smooth e = 0 against d
    in ``smooth_dtype``, add e back."""
    if sweeps <= 0:
        return u
    sdt = cfg.effective_smooth_dtype
    if sdt == u.dtype:
        return _smooth_raw(op, u, b, cfg, sweeps)
    d = op.residual(u, b).to(sdt)
    e = _smooth_raw(op, torch.zeros_like(d), d, cfg, sweeps)
    return (u + e.to(u.dtype)).to(u.dtype)


def _smooth_raw(op, u, b, cfg: MultigridConfig, sweeps: int):
    smoother, omega = _sm(cfg, sweeps)
    _no_stencil_kernel(cfg, op, u.dtype,
                       2 * sweeps if smoother == "rbgs" else sweeps)
    return op.smooth(u, b, smoother=smoother, omega=omega, sweeps=sweeps)


def _residual(op, u, b, cfg: MultigridConfig):
    _no_stencil_kernel(cfg, op, u.dtype, 1)
    return op.residual(u, b)


def _smooth_residual(op, u, b, cfg: MultigridConfig, sweeps: int):
    """Pre-smooth + residual."""
    smoother, _ = _sm(cfg, sweeps)
    if sweeps > 0 and cfg.effective_smooth_dtype == u.dtype:
        steps = (2 * sweeps if smoother == "rbgs" else sweeps) + 1
        _no_stencil_kernel(cfg, op, u.dtype, steps)
    u = _smooth(op, u, b, cfg, sweeps)
    return u, _residual(op, u, b, cfg)


# ---------------------------------------------------------------------------
# Transfers and the fused level visit
# ---------------------------------------------------------------------------

def _coarsest_solve(hier: Hierarchy, cfg: MultigridConfig, u, b):
    op = hier.levels[-1]
    if cfg.coarse_solver == "direct":
        return coarse_solve(op, hier.coarse_inv, b)
    return _smooth(op, u, b, cfg, cfg.coarse_smooth_sweeps)


def _transfer_kernels_ok(Sf, Sc, cfg: MultigridConfig, dtype) -> bool:
    return cfg.use_kernels and _t.supported(Sf, Sc, 0, dtype)


def _zeros(op, like):
    return like.new_zeros((op.S, op.S))


def _restrict(r, nf: int, Sc: int, cfg: MultigridConfig):
    if cfg.restriction == "injection":
        raise NotImplementedError("restriction='injection' is not ported yet")
    if _transfer_kernels_ok(r.shape[-1], Sc, cfg, r.dtype):
        raise NotImplementedError(
            "standalone restriction with use_kernels=True waits for the port "
            "of tpu_multigrid/kernels/transfer.py::_restrict_only")
    return ops.restrict_fw(r, nf, Sc)


def _prolong(e, nc: int, Sf: int, cfg: MultigridConfig):
    if cfg.prolongation == "p1":
        raise NotImplementedError("prolongation='p1' is not ported yet")
    return ops.prolong(e, nc, Sf)


def _prolong_add(u, e, nc: int, Sf: int, cfg: MultigridConfig):
    """u + P e."""
    if (cfg.prolongation == "bilinear"
            and _transfer_kernels_ok(Sf, e.shape[-1], cfg, u.dtype)):
        raise NotImplementedError(
            "standalone prolongation with use_kernels=True waits for the port "
            "of tpu_multigrid/kernels/transfer.py::_prolong_add_only")
    return u + _prolong(e, nc, Sf, cfg)


def _sdt_kernel(cfg: MultigridConfig, dtype):
    """``smooth_dtype`` argument of K1/K2: None for uniform precision."""
    sdt = cfg.effective_smooth_dtype
    return None if sdt == dtype else sdt


def _use_super_kernels(op, opc, cfg: MultigridConfig, dtype) -> bool:
    """Whether this level visit runs as K1 + K2."""
    if not (cfg.use_kernels and isinstance(op, ConstStencilOp)):
        return False
    if cfg.smoother not in ("jacobi", "rbgs", "chebyshev"):
        return False
    delta = _sdt_kernel(cfg, dtype) is not None
    if delta and dtype != torch.float32:
        return False
    if cfg.restriction != "fw" or cfg.prolongation != "bilinear":
        return False
    mult = 2 if cfg.smoother == "rbgs" else 1
    steps = mult * max(cfg.nu1, cfg.nu2) + (1 if delta else 0)
    return _t.supported(op.S, opc.S, steps, dtype)


def _fused_k1(op, opc, cfg: MultigridConfig, u, b):
    smoother, omega = _sm(cfg, cfg.nu1)
    return _t.smooth_restrict(u, b, op.n, opc.S, cfg.nu1, smoother, omega,
                              smooth_dtype=_sdt_kernel(cfg, u.dtype))


def _fused_k2(op, cfg: MultigridConfig, u, b, ec, *, resnorm=False):
    smoother, omega = _sm(cfg, cfg.nu2)
    sd = _sdt_kernel(cfg, u.dtype)
    if resnorm:
        return _t.prolong_smooth_resnorm(u, b, ec, op.n, cfg.nu2, smoother,
                                         omega, smooth_dtype=sd)
    return _t.prolong_smooth(u, b, ec, op.n, cfg.nu2, smoother, omega,
                             smooth_dtype=sd)


# ---------------------------------------------------------------------------
# V / W / F cycles
# ---------------------------------------------------------------------------

def _coarse_cycles(hier: Hierarchy, cfg: MultigridConfig, rc, k: int):
    """The coarse-grid correction of a level visit: one V, two W, or one F
    followed by one V cycle at level index k, from a zero guess."""
    ec = cycle(hier, cfg, _zeros(hier.levels[k], rc), rc, k)
    if cfg.cycle == "W":
        ec = cycle(hier, cfg, ec, rc, k)
    elif cfg.cycle == "F":
        ec = _vcycle_only(hier, cfg, ec, rc, k)
    return ec


def cycle(hier: Hierarchy, cfg: MultigridConfig, u, b, k: int = 0):
    """One multigrid cycle (V, W, or F per ``cfg.cycle``) at level index k
    (0 = finest)."""
    if k == hier.num_levels - 1:
        return _coarsest_solve(hier, cfg, u, b)
    op = hier.levels[k]
    opc = hier.levels[k + 1]
    fused = _use_super_kernels(op, opc, cfg, u.dtype)
    if fused:
        u, rc = _fused_k1(op, opc, cfg, u, b)
    else:
        u, r = _smooth_residual(op, u, b, cfg, cfg.nu1)
        rc = _restrict(r, op.n, opc.S, cfg)
    ec = _coarse_cycles(hier, cfg, rc, k + 1)
    if fused:
        return _fused_k2(op, cfg, u, b, ec)
    u = _prolong_add(u, ec, opc.n, op.S, cfg)
    return _smooth(op, u, b, cfg, cfg.nu2)


def _vcycle_only(hier, cfg, u, b, k):
    return cycle(hier, dataclasses.replace(cfg, cycle="V"), u, b, k)


def cycle_with_norm(hier: Hierarchy, cfg: MultigridConfig, u, b):
    """One finest-level cycle + the post-cycle residual norm (0-d float32).

    On the kernel path the norm is fused into the finest level's K2;
    otherwise it is one residual + norm pass.
    """
    if hier.num_levels == 1:
        u = _coarsest_solve(hier, cfg, u, b)
        return u, ops.norm2(hier.levels[0].residual(u, b))
    op = hier.levels[0]
    opc = hier.levels[1]
    if _use_super_kernels(op, opc, cfg, u.dtype):
        u, rc = _fused_k1(op, opc, cfg, u, b)
        ec = _coarse_cycles(hier, cfg, rc, 1)
        return _fused_k2(op, cfg, u, b, ec, resnorm=True)
    u = cycle(hier, cfg, u, b)
    return u, ops.norm2(_residual(op, u, b, cfg))


# ---------------------------------------------------------------------------
# Full multigrid
# ---------------------------------------------------------------------------

def fmg_rhs_hierarchy(hier: Hierarchy, cfg: MultigridConfig, b_fine,
                      b_levels: Optional[Sequence] = None) -> List:
    """Per-level RHS list, finest first: the fine RHS restricted down
    (``fmg_rhs="restrict"``) or the caller's assembled ``b_levels``."""
    if cfg.fmg_rhs == "assemble":
        if b_levels is None:
            raise ValueError('fmg_rhs="assemble" requires b_levels')
        return list(b_levels)
    bs = [b_fine]
    for k in range(hier.num_levels - 1):
        bs.append(_restrict(bs[-1], hier.levels[k].n, hier.levels[k + 1].S,
                            cfg))
    return bs


def fmg(hier: Hierarchy, cfg: MultigridConfig, b_fine,
        b_levels: Optional[Sequence] = None):
    """Full multigrid: coarsest solve, then prolong + nu0 cycles per level."""
    bs = fmg_rhs_hierarchy(hier, cfg, b_fine, b_levels)
    kc = hier.num_levels - 1
    u = _zeros(hier.levels[kc], b_fine)
    u = _coarsest_solve(hier, cfg, u, bs[kc])
    if cfg.coarse_solver == "smooth":
        for _ in range(cfg.nu0 - 1):
            u = _coarsest_solve(hier, cfg, u, bs[kc])
    for k in range(kc - 1, -1, -1):
        u = _prolong_add(_zeros(hier.levels[k], u), u, hier.levels[k + 1].n,
                         hier.levels[k].S, cfg)
        for _ in range(cfg.nu0):
            u = cycle(hier, cfg, u, bs[k], k)
    return u


# ---------------------------------------------------------------------------
# Convergence-driven solve drivers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SolveResult:
    """Solution + observability.

    ``u``: padded (S, S) solution grid at the finest level.
    ``res_history``: float32 CPU tensor of residual L2 norms before the
    solve and after each cycle (length ``cycles + 1``; NaN-padded in
    until-tol mode).
    ``iterations``: cycles actually run (int).
    ``converged``: whether the tolerance was met (always True in fixed mode).
    """

    u: Any
    res_history: Any
    iterations: int
    converged: bool

    @property
    def stalled(self) -> bool:
        """True when the solve stopped from stall detection (the iterate hit
        its precision floor) rather than tolerance or the cycle budget."""
        hist = torch.as_tensor(self.res_history).cpu().numpy()
        n = int(self.iterations)
        if bool(self.converged) or n + 1 >= hist.shape[0]:
            return False
        return bool(np.isnan(hist[n + 1:]).all())


def solve_fixed(hier: Hierarchy, cfg: MultigridConfig, b, num_cycles: int,
                u0=None) -> SolveResult:
    """Run exactly ``num_cycles`` cycles, recording the residual history."""
    op = hier.levels[0]
    u = u0 if u0 is not None else _zeros(op, b)
    hist = torch.full((num_cycles + 1,), float("nan"), dtype=torch.float32,
                      device=b.device)
    hist[0] = ops.norm2(op.residual(u, b))
    for i in range(num_cycles):
        u, rnorm = cycle_with_norm(hier, cfg, u, b)
        hist[i + 1] = rnorm
    return SolveResult(u=u, res_history=hist.cpu(), iterations=num_cycles,
                       converged=True)


def solve_until_tol(hier: Hierarchy, cfg: MultigridConfig, b, *, tol: float,
                    max_cycles: int = 100, relative: bool = True,
                    u0=None, stall_factor: float = 0.9,
                    r0_norm=None) -> SolveResult:
    """Cycle until the residual norm drops below ``tol`` (relative to the
    initial residual by default), stalls, or ``max_cycles`` is hit.

    Stall detection: when TWO CONSECUTIVE cycles each reduce the residual
    by less than ``stall_factor`` (``r_new > stall_factor * r_old`` twice in
    a row), the iterate has hit its precision floor and the loop exits with
    ``converged=False``.  Decisions are taken in float32, as the JAX driver
    takes them.
    """
    op = hier.levels[0]
    u = u0 if u0 is not None else _zeros(op, b)
    r0 = np.float32(ops.norm2(op.residual(u, b)).item())
    rbase = np.float32(r0_norm) if r0_norm is not None else r0
    target = np.float32(tol) * rbase if relative else np.float32(tol)
    target = max(target, np.float32(0.0))
    sf = np.float32(stall_factor)
    hist = np.full((max_cycles + 1,), np.nan, np.float32)
    hist[0] = r0
    i, rnorm, stalls = 0, r0, 0
    while i < max_cycles and rnorm > target and stalls < 2:
        u, rnew_t = cycle_with_norm(hier, cfg, u, b)
        rnew = np.float32(rnew_t.item())
        hist[i + 1] = rnew
        stalls = stalls + 1 if rnew > sf * rnorm else 0
        rnorm = rnew
        i += 1
    return SolveResult(u=u, res_history=torch.from_numpy(hist), iterations=i,
                       converged=bool(rnorm <= target))
