"""Cycle orchestration: V / W / F cycles, FMG, and convergence-driven solves.

The recursion walks the hierarchy in Python.  With ``use_kernels`` a level
visit whose level pair passes :func:`_use_super_kernels` is two kernel
launches, K1 (smooth + residual + restrict) and K2 (prolong + correct +
smooth, with the residual norm fused into the finest level's K2 in
:func:`cycle_with_norm`); a variable-coefficient pair that passes
:func:`_use_var_super_kernels` is K1v and K2v the same way.  Other
kernel-sized levels run the streaming smoothers (``kernels.stencil``,
``kernels.varstencil``) and the standalone transfers
(``kernels.transfer.restrict_fw`` / ``prolong_add``), as the JAX package
dispatches them; the rest run the plain torch operators.  The 2D constant-
and variable-coefficient branches of ``tpu_multigrid.cycles`` are here, and
the 3D constant-coefficient one: a 7-point or static-stencil (19-point)
pair that passes :func:`_use_super_kernels3` is K1_3 and K2_3, other
7-point levels run the 3D streaming smoother (``kernels.stencil3d``), and
the 3D transfers outside K1_3/K2_3 are plain torch, as in the JAX package;
and the 3D variable-coefficient one: a flux-stencil or variable-wind pair
that passes :func:`_use_var_super_kernels3` is K1v_3 and K2v_3, other such
levels run their plain operators (the JAX package has no 3D var smoother
kernel); and the zebra_x line smoother: a variable-coefficient pair that
passes :func:`_use_zebra_super_kernels` is K1z and K2z, other kernel-sized
levels run the zebra smoother kernel (``kernels.lines``).  A coarse
operator that owns its transfer pair (the periodic torus levels:
``restrict_into`` / ``prolong_add_into``) restricts and prolongs on the
plain level visit and in FMG, as in the JAX package; the torus's fused
tier is ``cycles.periodic_fused``.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from .. import kernels, tracing
from ..config import MultigridConfig
from ..core import ops, ops3d
from ..core.grids import Hierarchy, coarse_solve
from ..core.operators import (ConstStencilOp, ConstStencilOp3D, VarStencilOp,
                              VarStencilOp3D)
from ..kernels import stencil as _k
from ..kernels import stencil3d as _k3
from ..kernels import lines as _zl
from ..kernels import transfer as _t
from ..kernels import transfer3d as _t3
from ..kernels import varstencil as _v
from ..kernels import vartransfer as _vt
from ..kernels import vartransfer3d as _vt3


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


def _stencil_kernel_ok(op, cfg: MultigridConfig, dtype, steps: int) -> bool:
    return (cfg.use_kernels and isinstance(op, ConstStencilOp)
            and _k.supported(op.S, dtype, steps))


def _stencil3_kernel_ok(op, cfg: MultigridConfig, dtype, steps: int) -> bool:
    return (cfg.use_kernels and isinstance(op, ConstStencilOp3D)
            and _k3.supported3(op.grid_shape, dtype, steps))


def _var_kernel_ok(op, cfg: MultigridConfig, dtype, sweeps: int) -> bool:
    """Whether a variable-coefficient level smooths on the var-stencil
    kernel (5 symmetric or 9 nonsymmetric planes alike)."""
    if not (cfg.use_kernels and isinstance(op, VarStencilOp)):
        return False
    if cfg.smoother not in ("jacobi", "rbgs", "chebyshev"):
        return False
    if cfg.effective_smooth_dtype != dtype:
        return False
    steps = 2 * sweeps if cfg.smoother == "rbgs" else sweeps
    return _v.supported(op.S, steps, dtype)


def _smooth_raw(op, u, b, cfg: MultigridConfig, sweeps: int):
    smoother, omega = _sm(cfg, sweeps)
    steps = 2 * sweeps if smoother == "rbgs" else sweeps
    if _stencil_kernel_ok(op, cfg, u.dtype, steps):
        if smoother == "jacobi":
            return _k.jacobi_sweeps(u, b, op.n, omega, sweeps)
        if smoother == "rbgs":
            return _k.rbgs_sweeps(u, b, op.n, sweeps)
    if _stencil3_kernel_ok(op, cfg, u.dtype, steps):
        if smoother == "jacobi":
            return _k3.jacobi_sweeps3(u, b, op.n, omega, sweeps)
        if smoother == "rbgs":
            return _k3.rbgs_sweeps3(u, b, op.n, sweeps)
    if _var_kernel_ok(op, cfg, u.dtype, sweeps):
        return _v.var_smooth(u, b, _v._flat_coef(op), op.n, sweeps, smoother,
                             omega)
    if (cfg.use_kernels and isinstance(op, VarStencilOp)
            and smoother == "zebra_x"
            and cfg.effective_smooth_dtype == u.dtype
            and _zl.supported_zebra(op.S, sweeps, u.dtype)):
        return _zl.zebra_sweeps(u, b, _zebra_planes(op), op.n, sweeps)
    return op.smooth(u, b, smoother=smoother, omega=omega, sweeps=sweeps)


def _residual(op, u, b, cfg: MultigridConfig):
    if _stencil_kernel_ok(op, cfg, u.dtype, 1):
        return _k.residual(u, b, op.n)
    if _stencil3_kernel_ok(op, cfg, u.dtype, 1):
        return _k3.residual3(u, b, op.n)
    return op.residual(u, b)


def _smooth_residual(op, u, b, cfg: MultigridConfig, sweeps: int):
    """Pre-smooth + residual, one kernel launch where the level allows."""
    smoother, omega = _sm(cfg, sweeps)
    if sweeps > 0 and cfg.effective_smooth_dtype == u.dtype:
        steps = (2 * sweeps if smoother == "rbgs" else sweeps) + 1
        if _stencil_kernel_ok(op, cfg, u.dtype, steps):
            if smoother == "jacobi":
                return _k.jacobi_sweeps_residual(u, b, op.n, omega, sweeps)
            if smoother == "rbgs":
                return _k.rbgs_sweeps_residual(u, b, op.n, sweeps)
        if _stencil3_kernel_ok(op, cfg, u.dtype, steps):
            if smoother == "jacobi":
                return _k3.jacobi_sweeps_residual3(u, b, op.n, omega, sweeps)
            if smoother == "rbgs":
                return _k3.rbgs_sweeps_residual3(u, b, op.n, sweeps)
    if _var_kernel_ok(op, cfg, u.dtype, sweeps):
        return _v.var_smooth_residual(u, b, _v._flat_coef(op), op.n, sweeps,
                                      smoother, omega)
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
    """Zero grid of the operator's shape (2D by default)."""
    return like.new_zeros(getattr(op, "grid_shape", (op.S, op.S)))


def _ndim(op) -> int:
    return getattr(op, "ndim", 2)


def _tshape(op):
    """Transfer target size: the per-axis shape in 3D, S in 2D."""
    return op.grid_shape if _ndim(op) == 3 else op.S


def _restrict(r, nf: int, Sc, cfg: MultigridConfig, ndim: int = 2):
    if ndim == 3:
        return ops3d.restrict_fw3(r, nf, Sc)
    if cfg.restriction == "injection":
        return ops.restrict_injection(r, nf, Sc)
    if _transfer_kernels_ok(r.shape[-1], Sc, cfg, r.dtype):
        return _t.restrict_fw(r, nf, Sc)
    return ops.restrict_fw(r, nf, Sc)


def _prolong(e, nc: int, Sf: int, cfg: MultigridConfig):
    if cfg.prolongation == "p1":
        return ops.prolong_p1(e, nc, Sf)
    return ops.prolong(e, nc, Sf)


def _prolong_add(u, e, nc: int, Sf, cfg: MultigridConfig, ndim: int = 2):
    """u + P e (masked to the fine interior on the kernel)."""
    if ndim == 3:
        return u + ops3d.prolong3(e, nc, Sf)
    if (cfg.prolongation == "bilinear"
            and _transfer_kernels_ok(Sf, e.shape[-1], cfg, u.dtype)):
        return _t.prolong_add(u, e, 2 * nc)
    return u + _prolong(e, nc, Sf, cfg)


def _restrict_level(op, opc, r, cfg: MultigridConfig):
    """The fine residual restricted to the coarse level: the coarse
    operator's own ``restrict_into`` where it has one (the periodic torus
    levels own their transfer pair), else the configured restriction."""
    if hasattr(opc, "restrict_into"):
        return opc.restrict_into(r, op)
    return _restrict(r, op.n, _tshape(opc), cfg, _ndim(op))


def _prolong_add_level(op, opc, u, ec, cfg: MultigridConfig):
    """u + P ec, by the coarse operator's ``prolong_add_into`` where it
    has one, else the configured prolongation."""
    if hasattr(opc, "prolong_add_into"):
        return opc.prolong_add_into(u, ec, op)
    return _prolong_add(u, ec, opc.n, _tshape(op), cfg, _ndim(op))


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


def _use_var_super_kernels(op, opc, cfg: MultigridConfig, dtype) -> bool:
    """Whether this variable-coefficient level visit runs as K1v + K2v."""
    if not (cfg.use_kernels and isinstance(op, VarStencilOp)):
        return False
    if cfg.smoother not in ("jacobi", "rbgs", "chebyshev"):
        return False
    if cfg.effective_smooth_dtype != dtype:
        return False
    if cfg.restriction != "fw" or cfg.prolongation != "bilinear":
        return False
    mult = 2 if cfg.smoother == "rbgs" else 1
    steps = mult * max(cfg.nu1, cfg.nu2)
    return _vt.supported(op.S, opc.S, steps, dtype)


def _fused_k1v(op, opc, cfg: MultigridConfig, u, b):
    smoother, omega = _sm(cfg, cfg.nu1)
    return _vt.var_smooth_restrict_fused(u, b, _v._flat_coef(op), op.n,
                                         opc.S, cfg.nu1, smoother, omega)


def _fused_k2v(op, cfg: MultigridConfig, u, b, ec, *, resnorm=False):
    smoother, omega = _sm(cfg, cfg.nu2)
    if resnorm:
        return _vt.var_prolong_smooth_resnorm(u, b, ec, _v._flat_coef(op),
                                              op.n, cfg.nu2, smoother, omega)
    return _vt.var_prolong_smooth_fused(u, b, ec, _v._flat_coef(op), op.n,
                                        cfg.nu2, smoother, omega)


def _use_super_kernels3(op, opc, cfg: MultigridConfig, dtype) -> bool:
    """Whether this 3D level visit runs as K1_3 + K2_3: a 7-point pair, or
    a pair of constant compact stencils exposing ``STENCIL27`` (the
    19-point ``Const19Op``), whose weights the kernels take."""
    const7 = (isinstance(op, ConstStencilOp3D)
              and isinstance(opc, ConstStencilOp3D))
    const27 = (getattr(op, "STENCIL27", None) is not None
               and getattr(opc, "STENCIL27", None) is not None
               and _ndim(op) == 3)
    if not (cfg.use_kernels and (const7 or const27)):
        return False
    if cfg.smoother not in ("jacobi", "rbgs", "chebyshev"):
        return False
    if cfg.effective_smooth_dtype != dtype:
        return False
    if cfg.restriction != "fw" or cfg.prolongation != "bilinear":
        return False
    mult = 2 if cfg.smoother == "rbgs" else 1
    steps = mult * max(cfg.nu1, cfg.nu2)
    return _t3.supported3(op.grid_shape, opc.grid_shape, steps, dtype)


def _fused_k1_3d(op, opc, cfg: MultigridConfig, u, b):
    smoother, omega = _sm(cfg, cfg.nu1)
    return _t3.smooth_restrict3(u, b, op.n, opc.grid_shape, cfg.nu1,
                                smoother, omega,
                                stencil=getattr(op, "STENCIL27", None))


def _fused_k2_3d(op, cfg: MultigridConfig, u, b, ec, *, resnorm=False):
    smoother, omega = _sm(cfg, cfg.nu2)
    st = getattr(op, "STENCIL27", None)
    if resnorm:
        return _t3.prolong_smooth_resnorm3(u, b, ec, op.n, cfg.nu2, smoother,
                                           omega, stencil=st)
    return _t3.prolong_smooth3(u, b, ec, op.n, cfg.nu2, smoother, omega,
                               stencil=st)


def _use_var_super_kernels3(op, opc, cfg: MultigridConfig, dtype) -> bool:
    """Whether this 3D variable-coefficient level visit runs as K1v_3 +
    K2v_3: a ``VarStencilOp3D`` pair (3 planes, 4 with a reaction term) or
    a variable-wind ``Directional7Op`` pair (6 planes; constant winds carry
    ``STENCIL27`` and ride K1_3 / K2_3)."""
    if not cfg.use_kernels:
        return False
    from ..problems.convection3d import Directional7Op
    pair_var = (isinstance(op, VarStencilOp3D)
                and isinstance(opc, VarStencilOp3D))
    pair_dir = (isinstance(op, Directional7Op)
                and isinstance(opc, Directional7Op)
                and op.STENCIL27 is None and opc.STENCIL27 is None)
    if not (pair_var or pair_dir):
        return False
    if cfg.smoother not in ("jacobi", "rbgs", "chebyshev"):
        return False
    if cfg.effective_smooth_dtype != dtype:
        return False
    if cfg.restriction != "fw" or cfg.prolongation != "bilinear":
        return False
    mult = 2 if cfg.smoother == "rbgs" else 1
    steps = mult * max(cfg.nu1, cfg.nu2)
    nplanes = 6 if pair_dir else (3 if op.c2 is None else 4)
    return _vt3.supported_var3(op.grid_shape, opc.grid_shape, steps, dtype,
                               nplanes)


def _fused_k1v3(op, opc, cfg: MultigridConfig, u, b):
    smoother, omega = _sm(cfg, cfg.nu1)
    return _vt3.var_smooth_restrict3(u, b, _vt3._flat_coef3(op), op.n,
                                     opc.grid_shape, cfg.nu1, smoother, omega)


def _fused_k2v3(op, cfg: MultigridConfig, u, b, ec, *, resnorm=False):
    smoother, omega = _sm(cfg, cfg.nu2)
    coef = _vt3._flat_coef3(op)
    if resnorm:
        return _vt3.var_prolong_smooth_resnorm3(u, b, ec, coef, op.n,
                                                cfg.nu2, smoother, omega)
    return _vt3.var_prolong_smooth3(u, b, ec, coef, op.n, cfg.nu2, smoother,
                                    omega)


def _zebra_planes(op):
    """The zebra kernels' (9, S, S) view of the operator's stencil."""
    return op.coef.reshape(9, op.S, op.S)


def _use_zebra_super_kernels(op, opc, cfg: MultigridConfig, dtype) -> bool:
    """Whether this level visit runs as K1z + K2z: a variable-coefficient
    pair under the zebra_x smoother, full weighting and bilinear
    prolongation, on the shapes ``kernels.lines.supported_zebra_fused``
    takes."""
    if not (cfg.use_kernels and isinstance(op, VarStencilOp)
            and isinstance(opc, VarStencilOp)):
        return False
    if cfg.smoother != "zebra_x":
        return False
    if cfg.effective_smooth_dtype != dtype:
        return False
    if cfg.restriction != "fw" or cfg.prolongation != "bilinear":
        return False
    return _zl.supported_zebra_fused(op.S, opc.S, max(cfg.nu1, cfg.nu2),
                                     dtype)


def _fused_k1z(op, opc, cfg: MultigridConfig, u, b):
    return _zl.zebra_smooth_restrict(u, b, _zebra_planes(op), op.n, opc.S,
                                     cfg.nu1)


def _fused_k2z(op, cfg: MultigridConfig, u, b, ec, *, resnorm=False):
    if resnorm:
        return _zl.prolong_zebra_smooth_resnorm(u, b, ec, _zebra_planes(op),
                                                op.n, cfg.nu2)
    return _zl.prolong_zebra_smooth(u, b, ec, _zebra_planes(op), op.n,
                                    cfg.nu2)


def _level_visit_kernels(op, opc, cfg: MultigridConfig, dtype):
    """(K1, K2) of this level visit's fused pair, or None when it runs
    unfused, tested in the JAX package's order: the constant 2D pair, the
    variable-coefficient 2D one, the constant 3D one, the variable-
    coefficient 3D one, the zebra one."""
    if _use_super_kernels(op, opc, cfg, dtype):
        return _fused_k1, _fused_k2
    if _use_var_super_kernels(op, opc, cfg, dtype):
        return _fused_k1v, _fused_k2v
    if _use_super_kernels3(op, opc, cfg, dtype):
        return _fused_k1_3d, _fused_k2_3d
    if _use_var_super_kernels3(op, opc, cfg, dtype):
        return _fused_k1v3, _fused_k2v3
    if _use_zebra_super_kernels(op, opc, cfg, dtype):
        return _fused_k1z, _fused_k2z
    return None


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
    fused = _level_visit_kernels(op, opc, cfg, u.dtype)
    if fused:
        u, rc = fused[0](op, opc, cfg, u, b)
    else:
        u, r = _smooth_residual(op, u, b, cfg, cfg.nu1)
        rc = _restrict_level(op, opc, r, cfg)
    ec = _coarse_cycles(hier, cfg, rc, k + 1)
    if fused:
        return fused[1](op, cfg, u, b, ec)
    u = _prolong_add_level(op, opc, u, ec, cfg)
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
    fused = _level_visit_kernels(op, opc, cfg, u.dtype)
    if fused:
        u, rc = fused[0](op, opc, cfg, u, b)
        ec = _coarse_cycles(hier, cfg, rc, 1)
        return fused[1](op, cfg, u, b, ec, resnorm=True)
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
        bs.append(_restrict_level(hier.levels[k], hier.levels[k + 1], bs[-1],
                                  cfg))
    return bs


def fmg(hier: Hierarchy, cfg: MultigridConfig, b_fine,
        b_levels: Optional[Sequence] = None):
    """Full multigrid: coarsest solve, then prolong + nu0 cycles per level,
    in an ``fmg`` span (no ``solve`` root: it starts another driver).

    On the kernel route on the card, with the right-hand sides restricted
    from ``b_fine``, a hierarchy that runs the pass again is reused: the
    first call on one hierarchy, schedule and grid runs the pass as issued,
    the second captures it as a CUDA graph (:class:`_FmgGraph`), and that
    call and every later one replay it.  The pass is a few hundred launches
    on levels so small that the card would otherwise wait for the host to
    issue them; a hierarchy used once (a front door's) captures nothing."""
    with tracing.span("fmg", b_fine):
        if not _fmg_graphable(hier, cfg, b_fine):
            return _fmg(hier, cfg, b_fine, b_levels)
        graphs = _FMG_GRAPHS.setdefault(hier, {})
        key = (cfg, tuple(b_fine.shape), b_fine.dtype, b_fine.device)
        if key not in graphs:
            graphs[key] = None
            return _fmg(hier, cfg, b_fine, None)
        if graphs[key] is None:
            graphs[key] = _FmgGraph(hier, cfg, b_fine)
        return graphs[key](b_fine)


# The FMG passes captured on each hierarchy: key -> _FmgGraph, or None
# once the pass has run as issued.
_FMG_GRAPHS = weakref.WeakKeyDictionary()


def _fmg_graphable(hier: Hierarchy, cfg: MultigridConfig, b_fine) -> bool:
    """Whether the FMG pass may run as a CUDA graph: CUDA tensors, the
    kernel route, right-hand sides restricted from the fine one, and levels
    that transfer by the configured operators (not a torus's own pair)."""
    return (b_fine.is_cuda and cfg.use_kernels and cfg.fmg_rhs == "restrict"
            and not any(hasattr(op, "restrict_into") for op in hier.levels))


class _FmgGraph:
    """One FMG pass captured as a CUDA graph, its input and output buffers
    and the kernel launches it makes.  Capturing calls the kernel wrappers,
    which count launches that do not run: the counts are taken back, and
    each replay adds them.  A replay returns a copy of the output, so that
    the next one does not overwrite what a caller holds."""

    def __init__(self, hier: Hierarchy, cfg: MultigridConfig, b_fine):
        self.b = b_fine.clone()
        self.graph = torch.cuda.CUDAGraph()
        before = kernels.launch_counts()
        with torch.cuda.device(b_fine.device):
            with torch.cuda.graph(self.graph):
                self.u = _fmg(hier, cfg, self.b, None)
        after = kernels.launch_counts()
        self.launches = {k: v - before[k] for k, v in after.items()
                         if v != before[k]}
        self._count(-1)

    def __call__(self, b_fine):
        self.b.copy_(b_fine)
        self.graph.replay()
        self._count(1)
        return self.u.clone()

    def _count(self, sign: int) -> None:
        """Add ``sign`` times the pass's launches to the wrappers' counts."""
        for m in kernels._MODULES:
            for name in m.LAUNCHES:
                m.LAUNCHES[name] += sign * self.launches.get(name, 0)


def _fmg(hier: Hierarchy, cfg: MultigridConfig, b_fine,
         b_levels: Optional[Sequence]):
    """The FMG pass as issued, launch by launch."""
    bs = fmg_rhs_hierarchy(hier, cfg, b_fine, b_levels)
    kc = hier.num_levels - 1
    u = _zeros(hier.levels[kc], b_fine)
    u = _coarsest_solve(hier, cfg, u, bs[kc])
    if cfg.coarse_solver == "smooth":
        for _ in range(cfg.nu0 - 1):
            u = _coarsest_solve(hier, cfg, u, bs[kc])
    for k in range(kc - 1, -1, -1):
        op = hier.levels[k]
        u = _prolong_add_level(op, hier.levels[k + 1], _zeros(op, u), u, cfg)
        for _ in range(cfg.nu0):
            u = cycle(hier, cfg, u, bs[k], k)
    return u


# ---------------------------------------------------------------------------
# Convergence-driven solve drivers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SolveResult:
    """Solution + observability.

    ``u``: padded (S, S) or (S, S, Sx) solution grid at the finest level.
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
    with tracing.solve() as root:
        op = hier.levels[0]
        u = u0 if u0 is not None else _zeros(op, b)
        hist = torch.full((num_cycles + 1,), float("nan"),
                          dtype=torch.float32, device=b.device)
        hist[0] = ops.norm2(op.residual(u, b))
        for i in range(num_cycles):
            with tracing.span("cycle", b):
                u, rnorm = cycle_with_norm(hier, cfg, u, b)
            hist[i + 1] = rnorm
        root.set(iterations=num_cycles)
        return SolveResult(u=u, res_history=tracing.sync(hist, "history"),
                           iterations=num_cycles, converged=True)


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
    with tracing.solve() as root:
        op = hier.levels[0]
        u = u0 if u0 is not None else _zeros(op, b)
        r0 = np.float32(tracing.sync(ops.norm2(op.residual(u, b)), "norm"))
        rbase = np.float32(r0_norm) if r0_norm is not None else r0
        target = np.float32(tol) * rbase if relative else np.float32(tol)
        target = max(target, np.float32(0.0))
        sf = np.float32(stall_factor)
        hist = np.full((max_cycles + 1,), np.nan, np.float32)
        hist[0] = r0
        i, rnorm, stalls = 0, r0, 0
        while i < max_cycles and rnorm > target and stalls < 2:
            with tracing.span("cycle", b):
                u, rnew_t = cycle_with_norm(hier, cfg, u, b)
            rnew = np.float32(tracing.sync(rnew_t, "norm"))
            hist[i + 1] = rnew
            stalls = stalls + 1 if rnew > sf * rnorm else 0
            rnorm = rnew
            i += 1
        root.set(iterations=i)
        return SolveResult(u=u, res_history=torch.from_numpy(hist),
                           iterations=i, converged=bool(rnorm <= target))
