"""The wrap-aware fused tier of the periodic solve: V/W/F-cycles on the
torus through K1-local and K2-local (``kernels.local``).

The wrap rows of the torus sit exactly where a decomposed grid keeps its
ghosts, so this tier runs the ghost-extended block kernels with:

* the state held extended for the whole solve: ``(n + 2 GR, n + 2 GC)``
  arrays whose ghost rings are wrap copies (:func:`extend`); ``torch.roll``'s
  wrap becomes four strip copies per level visit (:func:`refresh`);
* the virtual interior: the kernels mask Dirichlet interiors in global
  coordinates, so ``origin = (2, 2)`` and a huge virtual ``n`` make every
  mask true.  Every cell of the extended block, ghosts included, smooths as
  a live unknown, and validity shrinks into the ghost ring with each step.

K1's coarse block is exactly the next level's extended block, so the fused
recursion composes.  The levels below the kernels' quanta (n not a multiple
of 256) run the plain ``PeriodicOp`` protocol path, and the coarsest level
applies the dense pseudo-inverse (mean-zero gauge) as always.  The kernels
run plain weighted Jacobi / RB-GS steps (row sums zero on the torus) and
variational transfers, so the mean-zero subspace is kept exactly as on the
protocol path, with no re-projection.

Each function computes what its namesake in ``tpu_multigrid.cycles.
periodic_fused`` computes, in the same order: the same ghost refreshes,
and none more (K1's output goes into K2 with its ghosts as they are).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import MultigridConfig
from ..core import ops
from ..core.grids import Hierarchy
from ..kernels import local as _kl
from ..kernels.local import GC, GR, supported_local

# Any even virtual n large enough that every global coordinate the kernels
# form stays in [1, n-1]: with origin (2, 2) the masks are true over the
# whole extended block.
VIRT_N = 1 << 30
ORIGIN = (2, 2)


def fused_levels(hier: Hierarchy, cfg: MultigridConfig, dtype) -> int:
    """Number of leading levels whose visits run the fused kernels: a level
    takes them when its extended block passes ``supported_local`` (n a
    multiple of 256, float32, the ghost depth covering the smoothing
    shrink) and it is not the coarsest (whose pseudo-inverse solve stays
    plain)."""
    if not cfg.use_kernels or dtype != torch.float32:
        return 0
    if cfg.effective_smooth_dtype != dtype:
        return 0
    if cfg.smoother not in ("jacobi", "rbgs", "chebyshev"):
        return 0
    mult = 2 if cfg.smoother == "rbgs" else 1
    steps = mult * max(cfg.nu1, cfg.nu2, 1) + 1   # +1: K2's resnorm ring
    depth = 0
    for k in range(hier.num_levels - 1):
        n = hier.levels[k].n
        if n % 2 or not supported_local(n + 2 * GR, n + 2 * GC, steps,
                                        dtype):
            break
        depth += 1
    return depth


def extend(x):
    """(n, n) torus grid -> its wrap-extended (n + 2 GR, n + 2 GC) block.
    The ghost rings wrap as often as they need: GC may exceed n."""
    n0, n1 = x.shape
    rows = torch.arange(-GR, n0 + GR, device=x.device) % n0
    cols = torch.arange(-GC, n1 + GC, device=x.device) % n1
    return x[rows][:, cols]


def owned(xe):
    """The owned (n, n) region of an extended block (a view)."""
    R, C = xe.shape
    return xe[GR:R - GR, GC:C - GC]


def refresh(xe):
    """Re-copy the wrap ghost rings from the owned region, in place: rows
    first, then columns over the refreshed rows, so the corners come out
    right.  Each source strip is read before its destination is written, as
    where the two overlap (a coarse block narrower than GC)."""
    R, C = xe.shape
    lr, lc = R - 2 * GR, C - 2 * GC
    xe[:GR] = xe[lr:lr + GR].clone()
    xe[R - GR:] = xe[GR:2 * GR].clone()
    xe[:, :GC] = xe[:, lc:lc + GC].clone()
    xe[:, C - GC:] = xe[:, GC:2 * GC].clone()
    return xe


def _cycle_ext(hier: Hierarchy, cfg: MultigridConfig, ue, be, k: int,
               depth: int, resnorm: bool = False):
    """One cycle visit at fused level k: ``ue``/``be`` are extended blocks
    with valid ghosts.  Returns u' extended (ghosts stale) and, with
    ``resnorm``, the owned post-smoothing residual norm."""
    from . import _sm, _vcycle_only, cycle
    sm1, om1 = _sm(cfg, cfg.nu1)
    sm2, om2 = _sm(cfg, cfg.nu2)
    ue, rce = _kl.smooth_restrict_ext(ue, be, ORIGIN, VIRT_N, cfg.nu1, sm1,
                                      om1)
    rce = refresh(rce)
    if k + 1 < depth:
        ece = _cycle_ext(hier, cfg, torch.zeros_like(rce), rce, k + 1, depth)
        if cfg.cycle in ("W", "F"):
            ece = refresh(ece)
            sub = cfg if cfg.cycle == "W" else dataclasses.replace(
                cfg, cycle="V")
            ece = _cycle_ext(hier, sub, ece, rce, k + 1, depth)
    else:
        rc = owned(rce)
        ec = cycle(hier, cfg, torch.zeros_like(rc), rc, k + 1)
        if cfg.cycle == "W":
            ec = cycle(hier, cfg, ec, rc, k + 1)
        elif cfg.cycle == "F":
            ec = _vcycle_only(hier, cfg, ec, rc, k + 1)
        ece = extend(ec)
    ece = refresh(ece)
    out = _kl.prolong_smooth_ext(ue, be, ece, ORIGIN, VIRT_N, cfg.nu2, sm2,
                                 om2, want_resnorm=resnorm)
    if resnorm:
        un, ss = out
        return un, torch.sqrt(ss)
    return out


def cycle_with_norm_ext(hier: Hierarchy, cfg: MultigridConfig, ue, be,
                        depth: int):
    """One finest-level fused cycle and the post-cycle residual norm (fused
    into K2).  The returned iterate's ghosts are refreshed, ready for the
    next cycle."""
    ue, rnorm = _cycle_ext(hier, cfg, ue, be, 0, depth, resnorm=True)
    return refresh(ue), rnorm


def solve_fixed_periodic(hier: Hierarchy, cfg: MultigridConfig, b,
                         num_cycles: int, u0=None):
    """The fused twin of ``cycles.solve_fixed``: the extended state is kept
    across cycles, so the embedding is paid once per solve."""
    from . import SolveResult
    op = hier.levels[0]
    depth = fused_levels(hier, cfg, b.dtype)
    u = u0 if u0 is not None else b.new_zeros(op.grid_shape)
    ue, be = extend(u), extend(b)
    hist = torch.full((num_cycles + 1,), float("nan"), dtype=torch.float32,
                      device=b.device)
    hist[0] = ops.norm2(op.residual(u, b))
    for i in range(num_cycles):
        ue, rnorm = cycle_with_norm_ext(hier, cfg, ue, be, depth)
        hist[i + 1] = rnorm
    return SolveResult(u=owned(ue).contiguous(), res_history=hist.cpu(),
                       iterations=num_cycles, converged=True)


def solve_until_tol_periodic(hier: Hierarchy, cfg: MultigridConfig, b, *,
                             tol: float, max_cycles: int = 100,
                             relative: bool = True, u0=None,
                             stall_factor: float = 0.9):
    """The fused twin of ``cycles.solve_until_tol``, with the same stall
    rule (two consecutive cycles that each reduce the residual by less than
    ``stall_factor`` end the solve) and float32 decisions.  The initial norm
    is ``PeriodicOp.residual``'s; each later one is K2-local's."""
    from . import SolveResult
    op = hier.levels[0]
    depth = fused_levels(hier, cfg, b.dtype)
    u = u0 if u0 is not None else b.new_zeros(op.grid_shape)
    ue, be = extend(u), extend(b)
    r0 = np.float32(ops.norm2(op.residual(u, b)).item())
    target = np.float32(tol) * r0 if relative else np.float32(tol)
    target = max(target, np.float32(0.0))
    sf = np.float32(stall_factor)
    hist = np.full((max_cycles + 1,), np.nan, np.float32)
    hist[0] = r0
    i, rnorm, stalls = 0, r0, 0
    while i < max_cycles and rnorm > target and stalls < 2:
        ue, rnew_t = cycle_with_norm_ext(hier, cfg, ue, be, depth)
        rnew = np.float32(rnew_t.item())
        hist[i + 1] = rnew
        stalls = stalls + 1 if rnew > sf * rnorm else 0
        rnorm = rnew
        i += 1
    return SolveResult(u=owned(ue).contiguous(),
                       res_history=torch.from_numpy(hist), iterations=i,
                       converged=bool(rnorm <= target))
