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

For the deepest tolerances at 16385^2 the iterate is a triple-single
u_hi + u_mid + u_lo (:func:`solve_refined_ts`), and the inner cycle keeps
its corrections double-single on the finest levels (:func:`cycle_ds`).
Ported here: the 2D and 3D branches of all of it (3D evaluates its
compensated residuals and transfers in plain torch, as the JAX package
does).  ``inner_dtype`` (a narrow inner cycle) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import MultigridConfig
from .core import ops, ops3d
from .core.grids import Hierarchy
from .cycles import (SolveResult, _coarsest_solve, _ndim, _restrict, _smooth,
                     _smooth_residual, _tshape, _zeros, cycle)
from .kernels import compres
from .kernels import transfer as _t


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
    """Sum of the 2·ndim shifted copies of u (z, y, x in 3D) with Neumaier
    compensation: (s, c) with s + c == the exact sum to ~eps^2."""
    axes = (-3, -2, -1) if u.ndim == 3 else (-2, -1)
    terms = [torch.roll(u, d, ax) for ax in axes for d in (1, -1)]
    s = terms[0]
    c = torch.zeros_like(u)
    for t in terms[1:]:
        s, e = _two_sum(s, t)
        c = c + e
    return s, c


def _mask_nd(r, n):
    if r.ndim == 3:
        return ops3d.mask_interior3(r, n)
    return ops.mask_interior(r, n)


def _nbr_nd(u):
    return ops3d.neighbor_sum3(u) if u.ndim == 3 else ops.neighbor_sum(u)


def _diag_terms(u) -> list:
    """-(diag * u) as exact products: [-4u] in 2D, [-4u, -2u] in 3D (6u
    itself rounds; 4u and 2u are exponent shifts)."""
    if u.ndim == 3:
        return [-4.0 * u, -2.0 * u]
    return [-4.0 * u]


def _ds_cascade(b, u_hi, nbr_hi, nbr_c, a_lo):
    """The ds-residual TwoSum cascade: r = b + nbr_hi - diag u_hi (the
    large, cancelling terms, exactly), then the small corrections."""
    s, e1 = _two_sum(b, nbr_hi)
    errs = [e1]
    for t in _diag_terms(u_hi):
        s, e = _two_sum(s, t)
        errs.append(e)
    cs = []
    for t in errs + [nbr_c, -a_lo]:
        s, c = _two_sum(s, t)
        cs.append(c)
    tail = cs[-1]
    for c in cs[-2::-1]:
        tail = c + tail
    return s + tail


def ds_residual(b, u_hi, u_lo, n: int):
    """r = b - A(u_hi + u_lo) with ~eps^2 accuracy, masked to the interior
    (2D: the plain version of ``kernels.compres.ds_residual``); 2D or 3D
    by ``b.ndim``."""
    nbr_hi, nbr_c = _neighbor_sum_compensated(u_hi)
    a_lo = 2.0 * b.ndim * u_lo - _nbr_nd(u_lo)
    return _mask_nd(_ds_cascade(b, u_hi, nbr_hi, nbr_c, a_lo), n)


def _ts_cascade(b, u_hi, u_mid, nbr_h, c_h, nbr_m, c_m, a_l):
    """The ts-residual TwoSum cascade (see :func:`_ds_cascade`)."""
    s, e1 = _two_sum(b, nbr_h)
    errs = [e1]
    for t in _diag_terms(u_hi):
        s, e = _two_sum(s, t)
        errs.append(e)
    s, e = _two_sum(s, nbr_m)
    errs.append(e)
    for t in _diag_terms(u_mid):
        s, e = _two_sum(s, t)
        errs.append(e)
    cs = []
    for t in errs + [c_h, c_m, -a_l]:
        s, c = _two_sum(s, t)
        cs.append(c)
    tail = cs[-1]
    for c in cs[-2::-1]:
        tail = c + tail
    return s + tail


def ts_residual(b, u_hi, u_mid, u_lo, n: int):
    """r = b - A(u_hi + u_mid + u_lo) to ~eps^3, masked to the interior
    (2D: the plain version of ``kernels.compres.ts_residual``); 2D or 3D by
    ``b.ndim``."""
    nbr_h, c_h = _neighbor_sum_compensated(u_hi)
    nbr_m, c_m = _neighbor_sum_compensated(u_mid)
    a_l = 2.0 * b.ndim * u_lo - _nbr_nd(u_lo)
    r = _ts_cascade(b, u_hi, u_mid, nbr_h, c_h, nbr_m, c_m, a_l)
    return _mask_nd(r, n)


def _ds_residual_d(b, u_hi, u_lo, n, use_kernels):
    """ds_residual, through the kernel when the grid is 2D and qualifies
    (the kernel is 2D only: a 3D grid's last side must not reach it)."""
    if use_kernels and b.ndim == 2 and compres.supported(b.shape[-1],
                                                         b.dtype):
        return compres.ds_residual(b, u_hi, u_lo, n)
    return ds_residual(b, u_hi, u_lo, n)


def _ts_residual_d(b, u_hi, u_mid, u_lo, n, use_kernels):
    if use_kernels and b.ndim == 2 and compres.supported(b.shape[-1],
                                                         b.dtype):
        return compres.ts_residual(b, u_hi, u_mid, u_lo, n)
    return ts_residual(b, u_hi, u_mid, u_lo, n)


def prolong_comp(ec, nc: int, Sf: int):
    """Bilinear prolongation with an exact error term: P ec == hi + err.

    All P weights are dyadic (1, 1/2, 1/4), so the only rounding happens in
    the 2- and 4-point neighbour sums, which TwoSum captures as ``err``.
    The odd-odd sum pairs each row first, as the JAX package's jnp route
    does (the kernel, ``kernels.transfer.prolong_comp``, pairs each column
    first, as the TPU kernel does).
    """
    Sc = ec.shape[-1]
    m = min(Sc, (Sf + 1) // 2)
    e = ec[:m, :m]
    hi = ec.new_zeros((Sf, Sf))
    err = ec.new_zeros((Sf, Sf))
    lim = 2 * m - 1
    hi[0:lim:2, 0:lim:2] = e
    s, t = _two_sum(e[:-1, :], e[1:, :])
    hi[1:lim - 1:2, 0:lim:2] = 0.5 * s
    err[1:lim - 1:2, 0:lim:2] = 0.5 * t
    s, t = _two_sum(e[:, :-1], e[:, 1:])
    hi[0:lim:2, 1:lim - 1:2] = 0.5 * s
    err[0:lim:2, 1:lim - 1:2] = 0.5 * t
    s1, t1 = _two_sum(e[:-1, :-1], e[:-1, 1:])
    s2, t2 = _two_sum(e[1:, :-1], e[1:, 1:])
    s, t3 = _two_sum(s1, s2)
    hi[1:lim - 1:2, 1:lim - 1:2] = 0.25 * s
    err[1:lim - 1:2, 1:lim - 1:2] = 0.25 * (t1 + t2 + t3)
    return ops.mask_interior(hi, 2 * nc), ops.mask_interior(err, 2 * nc)


def prolong_comp3(ec, nc: int, shape_f):
    """Trilinear prolongation with an exact error term: P ec == hi + err.

    The 3D analogue of :func:`prolong_comp`: each parity phase sums its 1,
    2, 4 or 8 coarse corners (z-shifted copies first, then y, then x) in a
    TwoSum cascade and scales by the exact 1/count; ``err`` is the scaled
    sum of the cascade's errors, added up as the JAX package adds them."""
    shf = ops3d._shape3(shape_f)
    m = tuple(min(ec.shape[ax], (shf[ax] + 1) // 2) for ax in range(3))
    e = ec[:m[0], :m[1], :m[2]]

    def shifted(v, ax):
        return ops3d._pad_end(v.narrow(ax, 1, v.shape[ax] - 1), ax)

    hi = ec.new_zeros(tuple(2 * x for x in m))
    err = torch.zeros_like(hi)
    for pz in (0, 1):
        for py in (0, 1):
            for px in (0, 1):
                terms = [e]
                for ax, p in ((0, pz), (1, py), (2, px)):
                    if p:
                        terms = terms + [shifted(t, ax) for t in terms]
                s = terms[0]
                errs = []
                for t in terms[1:]:
                    s, t2 = _two_sum(s, t)
                    errs.append(t2)
                scale = 1.0 / len(terms)
                sl = (slice(pz, None, 2), slice(py, None, 2),
                      slice(px, None, 2))
                hi[sl] = scale * s
                if errs:
                    acc = 0 + errs[0]
                    for t2 in errs[1:]:
                        acc = acc + t2
                    err[sl] = scale * acc
    nf = 2 * nc
    return (ops3d.mask_interior3(ops3d._crop_pad3(hi, shf), nf),
            ops3d.mask_interior3(ops3d._crop_pad3(err, shf), nf))


def cycle_ds(hier: Hierarchy, cfg: MultigridConfig, r, k: int = 0,
             ds_levels: int = 3):
    """One V-cycle on the defect equation A e = r, returning e as a
    double-single pair (e_hi, e_lo).

    On the finest ``ds_levels`` levels: pre-smoothing and the restricted
    defect stay plain f32; the sub-level correction comes back as a ds
    pair, is prolonged with an exact error term and accumulates by TwoSum;
    post-smoothing runs in delta form against the compensated defect of
    the accumulated pair.  Below them the plain cycle runs.  Only the
    V-cycle shape, as in the JAX package.
    """
    op = hier.levels[k]
    if k >= ds_levels or k == hier.num_levels - 1:
        if k == hier.num_levels - 1:
            e = _coarsest_solve(hier, cfg, torch.zeros_like(r), r)
        else:
            e = cycle(hier, cfg, torch.zeros_like(r), r, k=k)
        return e, torch.zeros_like(e)

    opc = hier.levels[k + 1]
    ndim = _ndim(op)
    e0, r1 = _smooth_residual(op, torch.zeros_like(r), r, cfg, cfg.nu1)
    rc = _restrict(r1, op.n, _tshape(opc), cfg, ndim)
    ec_hi, ec_lo = cycle_ds(hier, cfg, rc, k + 1, ds_levels)
    if (cfg.use_kernels and ndim == 2
            and _t.supported(op.S, opc.S, 0, r.dtype)):
        p_hi, p_err = _t.prolong_comp(ec_hi, op.n, op.S)
        p_lo = _t.prolong_add(p_err, ec_lo, op.n)
    elif ndim == 3:
        p_hi, p_err = prolong_comp3(ec_hi, opc.n, op.grid_shape)
        p_lo = ops3d.prolong3(ec_lo, opc.n, op.grid_shape) + p_err
    else:
        p_hi, p_err = prolong_comp(ec_hi, opc.n, op.S)
        p_lo = ops.prolong(ec_lo, opc.n, op.S) + p_err
    # accumulate (p_hi, p_lo) + e0 exactly, then post-smooth in delta form
    e_hi, e_lo = ds_add(p_hi, p_lo, e0)
    d0 = _ds_residual_d(r, e_hi, e_lo, op.n, cfg.use_kernels)
    delta = _smooth(op, torch.zeros_like(d0), d0, cfg, cfg.nu2)
    return ds_add(e_hi, e_lo, delta)


def _ts_renorm(a, b, c):
    """Renormalize three roughly-ordered components to a ts triple."""
    s, t = _two_sum(b, c)
    hi, t2 = _two_sum(a, s)
    mid, lo = _quick_two_sum(t2, t)
    return hi, mid, lo


def ts_add(hi, mid, lo, y):
    """(hi + mid + lo) + y in triple-single form (y a plain f32 array)."""
    s1, e1 = _two_sum(hi, y)
    s2, e2 = _two_sum(mid, e1)
    s3 = lo + e2
    return _ts_renorm(s1, s2, s3)


class _RefinementLoop:
    """The until-tol / fixed-count loop of the refinement drivers, with its
    decisions taken in float32 as the JAX drivers take them: continue while
    ``rnorm > target`` and the last iteration reduced the residual below
    ``stall_factor`` times the one before (fixed mode: exactly
    ``num_cycles`` iterations)."""

    def __init__(self, r0, tol, stall_factor, num_cycles, max_iters,
                 r0_norm=None):
        self.fixed = num_cycles is not None
        self.ncyc = num_cycles if self.fixed else max_iters
        r0 = np.float32(r0)
        rbase = np.float32(r0_norm) if r0_norm is not None else r0
        self.target = (np.float32(tol) * rbase if tol is not None
                       else np.float32(0.0))
        self.sf = np.float32(stall_factor)
        self.hist = np.full((self.ncyc + 1,), np.nan, np.float32)
        self.hist[0] = r0
        self.i, self.rnorm, self.prev = 0, r0, np.float32(np.inf)

    def running(self) -> bool:
        return self.i < self.ncyc and (
            self.fixed or (self.rnorm > self.target
                           and self.rnorm < self.sf * self.prev))

    def record(self, rnorm) -> None:
        self.prev, self.rnorm = self.rnorm, np.float32(rnorm)
        self.hist[self.i + 1] = self.rnorm
        self.i += 1

    def outcome(self):
        """(history as a float32 CPU tensor, iterations, converged)."""
        conv = True if self.fixed else bool(self.rnorm <= self.target)
        return torch.from_numpy(self.hist), self.i, conv


def _check_modes(tol, num_cycles) -> None:
    if tol is None and num_cycles is None:
        raise ValueError(
            "refined solve needs either tol (until-tol mode) or "
            "num_cycles (fixed-count mode); got tol=None, num_cycles=None")


def solve_refined_ts(hier: Hierarchy, cfg: MultigridConfig, b, *,
                     tol: Optional[float] = 1e-8, max_iters: int = 60,
                     stall_factor: float = 0.9,
                     num_cycles: Optional[int] = None,
                     ds_levels: int = 3):
    """Triple-single refinement: (u_hi, u_mid, u_lo, hist, iters, ok).

    The outer iterate is a ts triple (representation floor ~eps^3); the
    inner correction cycle runs with double-single corrections on the
    finest ``ds_levels`` levels (:func:`cycle_ds`), or is the plain cycle
    with ``ds_levels=0``.  ``hist`` is a float32 CPU tensor of residual
    norms, NaN-padded; stop rules as :func:`solve_refined_ds`.
    """
    _check_modes(tol, num_cycles)
    op = hier.levels[0]
    u_hi = _zeros(op, b)
    u_mid = torch.zeros_like(u_hi)
    u_lo = torch.zeros_like(u_hi)
    r = b
    loop = _RefinementLoop(ops.norm2(r).item(), tol, stall_factor,
                           num_cycles, max_iters)
    while loop.running():
        if ds_levels > 0:
            e_hi, e_lo = cycle_ds(hier, cfg, r, ds_levels=ds_levels)
            u_hi, u_mid, u_lo = ts_add(u_hi, u_mid, u_lo, e_hi)
            u_hi, u_mid, u_lo = ts_add(u_hi, u_mid, u_lo, e_lo)
        else:
            e = cycle(hier, cfg, torch.zeros_like(r), r)
            u_hi, u_mid, u_lo = ts_add(u_hi, u_mid, u_lo, e)
        r = _ts_residual_d(b, u_hi, u_mid, u_lo, op.n, cfg.use_kernels)
        loop.record(ops.norm2(r).item())
    return (u_hi, u_mid, u_lo) + loop.outcome()


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
    float32 CPU tensor of residual norms, NaN-padded.  ``ds_levels > 0``
    runs the inner cycle with double-single corrections on that many
    finest levels (:func:`cycle_ds`).
    """
    if inner_dtype is not None and ds_levels > 0:
        raise ValueError("inner_dtype and ds_levels are mutually exclusive")
    if inner_dtype is not None:
        raise NotImplementedError("inner_dtype (a narrow inner cycle) is not "
                                  "ported yet")
    _check_modes(tol, num_cycles)
    op = hier.levels[0]
    if u0 is not None:
        u_hi = u0.to(b.dtype)
        u_lo = (u0_lo.to(b.dtype) if u0_lo is not None
                else torch.zeros_like(u_hi))
        r = _ds_residual_d(b, u_hi, u_lo, op.n, cfg.use_kernels)
    else:
        u_hi = _zeros(op, b)
        u_lo = torch.zeros_like(u_hi)
        r = b
    loop = _RefinementLoop(ops.norm2(r).item(), tol, stall_factor,
                           num_cycles, max_iters, r0_norm)
    while loop.running():
        if ds_levels > 0:
            e_hi, e_lo = cycle_ds(hier, cfg, r, ds_levels=ds_levels)
            u_hi, u_lo = ds_add(u_hi, u_lo, e_hi)
            u_hi, u_lo = ds_add(u_hi, u_lo, e_lo)
        else:
            e = cycle(hier, cfg, torch.zeros_like(r), r)
            u_hi, u_lo = ds_add(u_hi, u_lo, e)
        r = _ds_residual_d(b, u_hi, u_lo, op.n, cfg.use_kernels)
        loop.record(ops.norm2(r).item())
    return (u_hi, u_lo) + loop.outcome()
