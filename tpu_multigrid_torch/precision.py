"""Compensated (double-single) iterative refinement for deep f32 solves.

With FEM scaling (b ~ h^2, u ~ O(1)) an f32-stored iterate has a
residual-evaluation floor of ~eps_f32 * ||A|| * ||u||: plain f32 cycles
stall long before a 1e-7 relative target at large grids.  Refinement gets
deeper residuals out of f32 storage:

* the iterate is kept in **double-single** form u = u_hi + u_lo (two f32
  arrays, an unevaluated sum);
* the residual r = b - A(u_hi + u_lo) is evaluated with error-free
  transformations (TwoSum/Neumaier compensation; 4*u_hi is exact),
  accurate to ~eps^2 — one launch of a ``kernels.compres`` kernel on the
  card, 2D or 3D; for the 3D flux stencil (``VarStencilOp3D``) in float64
  (:func:`ds_residual_var3`, a kernel of its own on the card too);
* the outer loop is iterative refinement with one multigrid cycle as the
  inner solver: e = MG(r); u += e (compensated accumulation).

For the deepest tolerances at 16385^2 the iterate is a triple-single
u_hi + u_mid + u_lo (:func:`solve_refined_ts`), and the inner cycle keeps
its corrections double-single on the finest levels (:func:`cycle_ds`).
Ported here: the 2D and 3D branches of all of it (3D keeps its compensated
transfers in plain torch, as the JAX package does; its compensated residual
has a kernel of its own, which the JAX package does not have).
``inner_dtype`` (a narrow inner cycle) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import tracing
from .config import MultigridConfig
from .core import ops, ops3d
from .core.grids import Hierarchy
from .core.operators import ConstStencilOp, ConstStencilOp3D, VarStencilOp3D
from .cycles import (SolveResult, _coarsest_solve, _ndim, _restrict, _smooth,
                     _smooth_residual, _tshape, _zeros, cycle)
from .kernels import compres, localref
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
    with tracing.span("accumulate", hi, kind="ds"):
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


def _diag_terms(u) -> list:
    """-(diag * u) as exact products: [-4u] in 2D, [-4u, -2u] in 3D (6u
    itself rounds; 4u and 2u are exponent shifts)."""
    if u.ndim == 3:
        return [-4.0 * u, -2.0 * u]
    return [-4.0 * u]


def _cascade(b, parts, nbrs, a_lo):
    """The compensated-residual TwoSum cascade of the iterate's leading
    ``parts`` (hi, or hi and mid), ``nbrs`` their compensated neighbour
    sums (nbr, c) and ``a_lo`` = A u_lo: r = b + each part's nbr - diag
    part in turn (the large, cancelling terms, exactly), then the small
    corrections (the errors, each c, -a_lo)."""
    s, errs = b, []
    for part, (nbr, _) in zip(parts, nbrs):
        s, e = _two_sum(s, nbr)
        errs.append(e)
        for t in _diag_terms(part):
            s, e = _two_sum(s, t)
            errs.append(e)
    cs = []
    for t in errs + [c for _, c in nbrs] + [-a_lo]:
        s, c = _two_sum(s, t)
        cs.append(c)
    tail = cs[-1]
    for c in cs[-2::-1]:
        tail = c + tail
    return s + tail


def _plain_residual(b, parts, n: int):
    """r = b - A(sum of ``parts``) by :func:`_cascade`, masked to the
    interior; 2D or 3D by ``b.ndim``."""
    lo = parts[-1]
    if b.ndim == 3:
        a_lo, mask = 6.0 * lo - ops3d.neighbor_sum3(lo), ops3d.mask_interior3
    else:
        a_lo, mask = 4.0 * lo - ops.neighbor_sum(lo), ops.mask_interior
    nbrs = [_neighbor_sum_compensated(p) for p in parts[:-1]]
    return mask(_cascade(b, parts[:-1], nbrs, a_lo), n)


def ds_residual(b, u_hi, u_lo, n: int):
    """r = b - A(u_hi + u_lo) with ~eps^2 accuracy, masked to the interior
    (2D: the plain version of ``kernels.compres.ds_residual``); 2D or 3D
    by ``b.ndim``."""
    return _plain_residual(b, (u_hi, u_lo), n)


def ts_residual(b, u_hi, u_mid, u_lo, n: int):
    """r = b - A(u_hi + u_mid + u_lo) to ~eps^3, masked to the interior
    (2D: the plain version of ``kernels.compres.ts_residual``); 2D or 3D by
    ``b.ndim``."""
    return _plain_residual(b, (u_hi, u_mid, u_lo), n)


# Nodes of one float64 temporary of :func:`ds_residual_var3_plain` (128
# MiB): it works in z-slabs of about this many nodes.
VAR3_SLAB_NODES = 1 << 24


def ds_residual_var3(op, b, u_hi, u_lo):
    """r = b - A(u_hi + u_lo) for a 3D flux stencil ``op``
    (``VarStencilOp3D``) in float64, rounded once to float32, masked to the
    interior: one launch of ``kernels.compres.ds_residual_var3`` on float32
    CUDA tensors, else :func:`ds_residual_var3_plain`, which the kernel
    equals bitwise."""
    if b.device.type == "cuda" and compres.supported_var3(op, b.dtype):
        return compres.ds_residual_var3(op, b, u_hi, u_lo)
    return ds_residual_var3_plain(op, b, u_hi, u_lo)


def ds_residual_var3_plain(op, b, u_hi, u_lo):
    """r = b - A(u_hi + u_lo) for a 3D flux stencil ``op``
    (``VarStencilOp3D``), evaluated in float64 from the float32 inputs and
    rounded once to float32, masked to the interior.

    A is the flux form of the operator's float32 transmissibilities,
    ``(A u)_i = sum_f t_f (u_i - u_f)`` over the six faces (x+, x-, y+, y-,
    z+, z-, summed in that order; the minus-face planes are the stored
    planes one node back), plus ``c2_i u_i`` where the operator has a
    reaction plane.  ``inv_diag``, rounded to float32, takes no part.

    Accuracy: u_lo lies within half an ulp of u_hi, so u_hi + u_lo spans
    at most 49 bits and is exact in float64 (a u_lo far below that rounds
    at 2^-53 |u|, under the pair's own representation error).  Each t_f is
    widened exactly; each flux and the sum of the six with b round at
    2^-53 of their size, some 2^-50 of sum_f t_f |u_i - u_f| in all.  A
    float32 evaluation errs by some 2^-21 of that sum, which is the floor
    (3e-3 of ||b|| at 513^3) that refinement gets under: float64 puts it
    29 bits lower, far under the 1e-8 asked of it.  The card has float64
    units, so the error-free transforms of the constant path (which the
    TPU, without float64, needs) are not needed here.

    Plain torch ops, the same on the card and on the CPU, over z-slabs of
    about ``VAR3_SLAB_NODES`` nodes, so that the float64 temporaries stay
    a few slabs in size: the CPU path, and the kernel's oracle."""
    n = op.n
    tz, ty, tx, c2 = op.tz, op.ty, op.tx, op.c2
    r = torch.zeros_like(b)
    slab = max(1, VAR3_SLAB_NODES // (n + 1) ** 2)
    ins = slice(1, n)
    for z0 in range(1, n, slab):
        z1 = min(z0 + slab, n)
        zs = slice(z0, z1)
        # u over the slab and one node around it, in float64 (exact).
        u = (u_hi[z0 - 1:z1 + 1, :n + 1, :n + 1].double()
             + u_lo[z0 - 1:z1 + 1, :n + 1, :n + 1])
        c = u[1:-1, 1:-1, 1:-1]
        acc = tx[zs, ins, ins] * (c - u[1:-1, 1:-1, 2:])
        acc += tx[zs, ins, 0:n - 1] * (c - u[1:-1, 1:-1, :-2])
        acc += ty[zs, ins, ins] * (c - u[1:-1, 2:, 1:-1])
        acc += ty[zs, 0:n - 1, ins] * (c - u[1:-1, :-2, 1:-1])
        acc += tz[zs, ins, ins] * (c - u[2:, 1:-1, 1:-1])
        acc += tz[z0 - 1:z1 - 1, ins, ins] * (c - u[:-2, 1:-1, 1:-1])
        if c2 is not None:
            acc += c2[zs, ins, ins] * c
        r[zs, ins, ins] = b[zs, ins, ins] - acc
    return r


# The level operators each compensated residual takes: ds for the constant
# 5- and 7-point Laplacians and the 3D flux stencil, ts for the constant
# ones only.
_DS_OPS = (ConstStencilOp, ConstStencilOp3D, VarStencilOp3D)
_TS_OPS = (ConstStencilOp, ConstStencilOp3D)


def compensable(op, kind: str = "ds") -> bool:
    """Whether the refinement drivers hold a compensated ``kind`` ("ds" or
    "ts") residual for the level operator ``op``."""
    return isinstance(op, _DS_OPS if kind == "ds" else _TS_OPS)


def _require_compensable(op, kind: str = "ds") -> None:
    """Refuse an operator with no compensated residual: refinement would
    correct toward another operator's solution."""
    if not compensable(op, kind):
        raise NotImplementedError(
            f"no compensated {kind} residual for {type(op).__name__}: "
            f"refinement would correct toward another operator's solution")


def _comp_residual(b, parts, op, use_kernels):
    """The compensated residual b - A(sum of ``parts``) of the level
    operator ``op``: ds for a pair, ts for a triple.  The 3D flux
    stencil's (ds only) in float64; the constant Laplacian's through the
    2D kernel when the grid is 2D and qualifies, through the 3D kernel
    when it is 3D and qualifies (a 3D grid's last side never reaches the
    2D kernel), else in plain torch.  Any other operator raises."""
    ds = len(parts) == 2
    if ds and isinstance(op, VarStencilOp3D):
        with tracing.span("residual", b, path="var3"):
            return ds_residual_var3(op, b, *parts)
    _require_compensable(op, "ds" if ds else "ts")
    if b.ndim == 3:
        kernel = compres.ds_residual3 if ds else compres.ts_residual3
        fits = compres.supported3(b.shape, b.dtype)
    else:
        kernel = compres.ds_residual if ds else compres.ts_residual
        fits = compres.supported(b.shape[-1], b.dtype)
    if use_kernels and fits:
        with tracing.span("residual", b, path="kernel"):
            return kernel(b, *parts, op.n)
    with tracing.span("residual", b, path="plain"):
        return (ds_residual if ds else ts_residual)(b, *parts, op.n)


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

    _require_compensable(op)
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
    e = [p_hi, p_lo]
    _accumulate(e, (e0,), cfg.use_kernels)
    d0 = _comp_residual(r, e, op, cfg.use_kernels)
    delta = _smooth(op, torch.zeros_like(d0), d0, cfg, cfg.nu2)
    _accumulate(e, (delta,), cfg.use_kernels)
    return tuple(e)


def ts_add(hi, mid, lo, y):
    """(hi + mid + lo) + y in triple-single form (y a plain f32 array)."""
    with tracing.span("accumulate", hi, kind="ts"):
        s1, e1 = _two_sum(hi, y)
        s2, e2 = _two_sum(mid, e1)
        s3 = lo + e2
        # renormalise the three roughly-ordered sums to a ts triple
        s, t = _two_sum(s2, s3)
        hi, t2 = _two_sum(s1, s)
        return (hi,) + _quick_two_sum(t2, t)


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


def _accumulate(parts: list, ys, use_kernels: bool = False) -> None:
    """parts (a ds pair or ts triple) += each y of ``ys`` in turn, in the
    list, so that no earlier sum stays alive.  With ``use_kernels`` on
    float32 CUDA tensors, one ``kernels.localref.comp_add_ext`` launch in
    one ``accumulate`` span writes the sums over the parts' own storage:
    the caller must own them, and no y may share it.  Otherwise
    :func:`ds_add` / :func:`ts_add` per y, with the same bits.  A CPU
    tensor never takes the kernel route: ``comp_add_ext``'s CPU version
    calls this function."""
    hi = parts[0]
    if use_kernels and hi.device.type == "cuda" and hi.dtype == torch.float32:
        with tracing.span("accumulate", hi,
                          kind="ds" if len(parts) == 2 else "ts"):
            localref.comp_add_ext(parts, ys)
        return
    add = ds_add if len(parts) == 2 else ts_add
    for y in ys:
        parts[:] = add(*parts, y)


def _refine(hier, cfg, b, nparts, ds_levels, tol, stall_factor, num_cycles,
            max_iters, u0=None, u0_lo=None, r0_norm=None):
    """The one loop of :func:`solve_refined_ds` and :func:`solve_refined_ts`,
    on an iterate of ``nparts`` parts (2, a ds pair, or 3, a ts triple)
    under one ``solve`` span: from zero, or from ``u0`` (+ ``u0_lo``) and
    its residual; then, while the
    :class:`_RefinementLoop` runs, one cycle on the defect
    (:func:`cycle_ds` with ``ds_levels``, else the plain cycle), the
    compensated accumulation of its correction, the compensated residual
    and its norm.  Returns the parts + (hist, iterations, converged).  No
    name outside ``parts`` holds a part: each sum is freed when the next
    replaces it."""
    _check_modes(tol, num_cycles)
    op = hier.levels[0]
    _require_compensable(op, "ds" if nparts == 2 else "ts")
    with tracing.solve() as root:
        if u0 is None:
            parts, r = [_zeros(op, b) for _ in range(nparts)], b
        else:
            # Copies: the parts are overwritten in place on the card.
            parts = [u0.to(b.dtype, copy=True)]
            parts.append(torch.zeros_like(parts[0]) if u0_lo is None
                         else u0_lo.to(b.dtype, copy=True))
            r = _comp_residual(b, parts, op, cfg.use_kernels)
        loop = _RefinementLoop(tracing.sync(ops.norm2(r), "norm"), tol,
                               stall_factor, num_cycles, max_iters, r0_norm)
        while loop.running():
            with tracing.span("cycle", r):
                e = (cycle_ds(hier, cfg, r, ds_levels=ds_levels)
                     if ds_levels > 0
                     else (cycle(hier, cfg, torch.zeros_like(r), r),))
            _accumulate(parts, e, cfg.use_kernels)
            r = _comp_residual(b, parts, op, cfg.use_kernels)
            loop.record(tracing.sync(ops.norm2(r), "norm"))
        root.set(iterations=loop.i)
        return tuple(parts) + loop.outcome()


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
    norms, NaN-padded; stop rules as :func:`solve_refined_ds`.  The
    finest operator is a constant 5- or 7-point Laplacian; any other
    raises ``NotImplementedError``.
    """
    return _refine(hier, cfg, b, 3, ds_levels, tol, stall_factor,
                   num_cycles, max_iters)


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
    finest levels (:func:`cycle_ds`).  The finest operator is a constant
    5- or 7-point Laplacian or a ``VarStencilOp3D`` (:func:`compensable`);
    any other raises ``NotImplementedError``.
    """
    if inner_dtype is not None and ds_levels > 0:
        raise ValueError("inner_dtype and ds_levels are mutually exclusive")
    if inner_dtype is not None:
        raise NotImplementedError("inner_dtype (a narrow inner cycle) is not "
                                  "ported yet")
    return _refine(hier, cfg, b, 2, ds_levels, tol, stall_factor,
                   num_cycles, max_iters, u0, u0_lo, r0_norm)
