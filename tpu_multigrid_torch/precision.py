"""Compensated (double-single) iterative refinement for deep f32 solves.

With FEM scaling (b ~ h^2, u ~ O(1)) an f32-stored iterate has a
residual-evaluation floor of ~eps_f32 * ||A|| * ||u||: plain f32 cycles
stall long before a 1e-7 relative target at large grids.  Refinement gets
deeper residuals out of f32 storage:

* the iterate is kept in **double-single** form u = u_hi + u_lo (two f32
  arrays, an unevaluated sum);
* the residual r = b - A(u_hi + u_lo) is evaluated with error-free
  transformations (TwoSum/Neumaier compensation; 4*u_hi is exact),
  accurate to ~eps^2 — one launch of the ``kernels.compres`` kernel on the
  card;
* the outer loop is iterative refinement with one multigrid cycle as the
  inner solver: e = MG(r); u += e (compensated accumulation).

Ported here: the ds/ts residuals and ``solve_refined_ds`` with
``ds_levels=0`` and no ``inner_dtype``.  ``cycle_ds`` and
``solve_refined_ts`` wait for kernels that are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import MultigridConfig
from .core import ops
from .core.grids import Hierarchy
from .cycles import SolveResult, cycle


def _two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly (6 flops)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _quick_two_sum(a, b):
    """Fast TwoSum, requires |a| >= |b|: s + e == a + b exactly."""
    s = a + b
    e = b - (s - a)
    return s, e


def ds_add(hi, lo, y):
    """(hi + lo) + y in double-single form (y a plain f32 array)."""
    s, e = _two_sum(hi, y)
    lo2 = lo + e
    return _quick_two_sum(s, lo2)


def _neighbor_sum_compensated(u):
    """Sum of the four shifted copies of u with Neumaier compensation:
    (s, c) with s + c == the exact sum to ~eps^2."""
    terms = [torch.roll(u, 1, -2), torch.roll(u, -1, -2),
             torch.roll(u, 1, -1), torch.roll(u, -1, -1)]
    s = terms[0]
    c = torch.zeros_like(u)
    for t in terms[1:]:
        s, e = _two_sum(s, t)
        c = c + e
    return s, c


def _ds_cascade(b, u_hi, nbr_hi, nbr_c, a_lo):
    """The ds-residual TwoSum cascade: r = b + nbr_hi - 4 u_hi (the large,
    cancelling terms, exactly), then the small corrections."""
    s, e1 = _two_sum(b, nbr_hi)
    s, e2 = _two_sum(s, -4.0 * u_hi)
    cs = []
    for t in (e1, e2, nbr_c, -a_lo):
        s, c = _two_sum(s, t)
        cs.append(c)
    tail = cs[-1]
    for c in cs[-2::-1]:
        tail = c + tail
    return s + tail


def ds_residual(b, u_hi, u_lo, n: int):
    """r = b - A(u_hi + u_lo) with ~eps^2 accuracy, masked to the interior
    (the plain version of ``kernels.compres.ds_residual``)."""
    nbr_hi, nbr_c = _neighbor_sum_compensated(u_hi)
    a_lo = 4.0 * u_lo - ops.neighbor_sum(u_lo)
    return ops.mask_interior(_ds_cascade(b, u_hi, nbr_hi, nbr_c, a_lo), n)


def _ts_cascade(b, u_hi, u_mid, nbr_h, c_h, nbr_m, c_m, a_l):
    """The ts-residual TwoSum cascade (see :func:`_ds_cascade`)."""
    s, e1 = _two_sum(b, nbr_h)
    s, e2 = _two_sum(s, -4.0 * u_hi)
    s, e3 = _two_sum(s, nbr_m)
    s, e4 = _two_sum(s, -4.0 * u_mid)
    cs = []
    for t in (e1, e2, e3, e4, c_h, c_m, -a_l):
        s, c = _two_sum(s, t)
        cs.append(c)
    tail = cs[-1]
    for c in cs[-2::-1]:
        tail = c + tail
    return s + tail


def ts_residual(b, u_hi, u_mid, u_lo, n: int):
    """r = b - A(u_hi + u_mid + u_lo) to ~eps^3, masked to the interior
    (the plain version of ``kernels.compres.ts_residual``)."""
    nbr_h, c_h = _neighbor_sum_compensated(u_hi)
    nbr_m, c_m = _neighbor_sum_compensated(u_mid)
    a_l = 4.0 * u_lo - ops.neighbor_sum(u_lo)
    r = _ts_cascade(b, u_hi, u_mid, nbr_h, c_h, nbr_m, c_m, a_l)
    return ops.mask_interior(r, n)


def _ds_residual_d(b, u_hi, u_lo, n, use_kernels):
    """ds_residual, through the kernel when the grid qualifies."""
    from .kernels import compres
    if use_kernels and compres.supported(b.shape[-1], b.dtype):
        return compres.ds_residual(b, u_hi, u_lo, n)
    return ds_residual(b, u_hi, u_lo, n)


def _ts_residual_d(b, u_hi, u_mid, u_lo, n, use_kernels):
    from .kernels import compres
    if use_kernels and compres.supported(b.shape[-1], b.dtype):
        return compres.ts_residual(b, u_hi, u_mid, u_lo, n)
    return ts_residual(b, u_hi, u_mid, u_lo, n)


_CYCLE_DS_WAITS = (
    "cycle_ds, which waits for the ports of tpu_multigrid/kernels/"
    "transfer.py::_prolong_comp_only, ::_restrict_only, ::_prolong_add_only "
    "and kernels/stencil.py::_streamed")


def cycle_ds(*args, **kwargs):
    raise NotImplementedError(f"not ported yet: {_CYCLE_DS_WAITS}")


def solve_refined_ts(*args, **kwargs):
    raise NotImplementedError(f"solve_refined_ts runs {_CYCLE_DS_WAITS}")


def solve_refined(hier: Hierarchy, cfg: MultigridConfig, b, *,
                  tol: Optional[float] = 1e-8, max_iters: int = 60,
                  stall_factor: float = 0.9,
                  num_cycles: Optional[int] = None,
                  u0=None, u0_lo=None, r0_norm=None) -> SolveResult:
    """Iterative refinement: MG cycle on the compensated defect equation.

    Returns a SolveResult whose ``u`` is the high-order part of the
    double-single iterate (use :func:`solve_refined_ds` for both parts).
    ``num_cycles`` forces a fixed iteration count (no tol/stall exit).
    """
    u_hi, _, hist, iters, conv = solve_refined_ds(
        hier, cfg, b, tol=tol, max_iters=max_iters,
        stall_factor=stall_factor, num_cycles=num_cycles,
        u0=u0, u0_lo=u0_lo, r0_norm=r0_norm)
    return SolveResult(u=u_hi, res_history=hist, iterations=iters,
                       converged=conv)


def solve_refined_ds(hier: Hierarchy, cfg: MultigridConfig, b, *,
                     tol: Optional[float] = 1e-8, max_iters: int = 60,
                     stall_factor: float = 0.9,
                     num_cycles: Optional[int] = None,
                     u0=None, u0_lo=None, r0_norm=None,
                     ds_levels: int = 0, inner_dtype=None):
    """Full double-single refinement state: (u_hi, u_lo, hist, iters, ok).

    Until-tol mode stops at the target or after the FIRST iteration that
    does not reduce the residual by ``stall_factor``.  ``hist`` is a
    float32 CPU tensor of residual norms, NaN-padded.
    """
    if ds_levels > 0:
        raise NotImplementedError(f"ds_levels > 0 runs {_CYCLE_DS_WAITS}")
    if inner_dtype is not None:
        raise NotImplementedError("inner_dtype (a narrow inner cycle) is not "
                                  "ported yet")
    if tol is None and num_cycles is None:
        raise ValueError(
            "refined solve needs either tol (until-tol mode) or "
            "num_cycles (fixed-count mode); got tol=None, num_cycles=None")
    op = hier.levels[0]
    fixed = num_cycles is not None
    ncyc = num_cycles if fixed else max_iters

    if u0 is not None:
        u_hi = u0.to(b.dtype)
        u_lo = (u0_lo.to(b.dtype) if u0_lo is not None
                else torch.zeros_like(u_hi))
        r = _ds_residual_d(b, u_hi, u_lo, op.n, cfg.use_kernels)
    else:
        u_hi = b.new_zeros((op.S, op.S))
        u_lo = torch.zeros_like(u_hi)
        r = b
    r0 = np.float32(ops.norm2(r).item())
    rbase = np.float32(r0_norm) if r0_norm is not None else r0
    target = np.float32(tol) * rbase if tol is not None else np.float32(0.0)
    sf = np.float32(stall_factor)
    hist = np.full((ncyc + 1,), np.nan, np.float32)
    hist[0] = r0
    i, rnorm, prev = 0, r0, np.float32(np.inf)
    while i < ncyc and (fixed or (rnorm > target and rnorm < sf * prev)):
        e = cycle(hier, cfg, torch.zeros_like(r), r)
        u_hi, u_lo = ds_add(u_hi, u_lo, e)
        r = _ds_residual_d(b, u_hi, u_lo, op.n, cfg.use_kernels)
        prev, rnorm = rnorm, np.float32(ops.norm2(r).item())
        hist[i + 1] = rnorm
        i += 1
    conv = True if fixed else bool(rnorm <= target)
    return u_hi, u_lo, torch.from_numpy(hist), i, conv
