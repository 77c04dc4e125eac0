"""Distributed FAS multigrid on the fused extended-block kernels.

The nonlinear twin of :mod:`.pallas_cycle`: each sharded FAS level visit
is one ghost exchange and one K1f-local launch (nonlinear sweeps, the
nonlinear residual, the solution injection and the coarse FAS right-hand
side) downward, and one exchange and one K2f-local launch (prolongation,
correction, nonlinear sweeps, and on the finest level the owned nonlinear
residual's sum of squares for the stopping test) upward
(:mod:`tpu_multigrid_torch.kernels.localfas`).

What FAS adds to the linear fused cycle: K1f-local emits two coarse
extended blocks, the injected solution ``uc0`` (the next level's initial
iterate) and the FAS right-hand side ``bc``, both ghost-refreshed before
the coarse visit; the correction is ``uc - uc0`` (valid on the owned
region), ghost-refreshed before K2f-local.  Below the replication switch
the gathered blocks run the single-device FAS recursion
(``cycles.fas.fas_cycle``) on every rank over a replicated tail: a
``PointwiseNonlinearOp`` hierarchy ending in the dense Newton coarsest
solve (:func:`.fas.build_replicated_tail`), or ``QuasilinearFluxOp``
levels.  The tail runs the operators' plain torch methods, as the linear
tier's replicated levels do.

A port of ``tpu_multigrid/dist/fas_pallas.py`` on ``torch.distributed``,
as :mod:`.pallas_cycle` is of its JAX twin: the code that ran inside
``shard_map`` runs on every rank with the :class:`.mesh.GridMesh` passed
explicitly, and the ``lax.while_loop`` is a Python loop whose stop test
reads a norm every rank holds after the all-reduce.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..config import MultigridConfig
from ..core.grids import Hierarchy
from ..core.nonlinear import QuasilinearFluxOp
from ..cycles import SolveResult
from ..cycles.fas import fas_cycle
from ..kernels import localfas as KLF
from . import local_ops as L
from .fas import _n_residual_local, build_replicated_tail
from .mesh import GridMesh
from .pallas_cycle import (GC, GR, _ext_origin, _extend_local, _halo_depths,
                           _no_shardable_level, gather_owned, owned_view,
                           pallas_level_sizes, refresh_ghosts, rhs_ext,
                           scatter_owned)
from .shard_cycle import ShardedLevels


def _k1f(u, b, origin, n, cfg, phi, dphi, a):
    if a is not None:
        return KLF.qfas_smooth_restrict_ext(u, b, origin, n, cfg.nu1,
                                            float(cfg.omega), a)
    return KLF.fas_smooth_restrict_ext(u, b, origin, n, cfg.nu1,
                                       float(cfg.omega), phi, dphi,
                                       (1.0 / n) ** 2)


def _k2f(u, b, ec, origin, n, cfg, phi, dphi, a, want):
    if a is not None:
        return KLF.qfas_prolong_smooth_ext(u, b, ec, origin, n, cfg.nu2,
                                           float(cfg.omega), a,
                                           want_resnorm=want)
    return KLF.fas_prolong_smooth_ext(u, b, ec, origin, n, cfg.nu2,
                                      float(cfg.omega), phi, dphi,
                                      (1.0 / n) ** 2, want_resnorm=want)


def _sub_configs(cfg: MultigridConfig):
    """The configs of a visit's coarse sub-cycles: two for W and F (F's
    second one a V-cycle), one for V."""
    if cfg.cycle == "V":
        return (cfg,)
    return (cfg, cfg if cfg.cycle == "W" else
            dataclasses.replace(cfg, cycle="V"))


def _fas_vcycle_pallas(mesh: GridMesh, levels: ShardedLevels,
                       tail: Hierarchy, cfg: MultigridConfig, k: int, u, b,
                       *, phi, dphi, a=None, want_norm: bool = False,
                       halo: str = "lean", u_ghosts_fresh: bool = False):
    """FAS V/W/F-cycle at sharded level k on extended blocks.

    ``b``'s ghosts must be valid on entry.  Returns u' (owned region valid),
    and with ``want_norm`` also the global nonlinear residual norm (0-d
    float32).  ``u_ghosts_fresh`` skips the pre-K1f exchange, as in
    :func:`.pallas_cycle._vcycle_pallas`."""
    my, mx = mesh.shape
    n, S = levels.sizes[k]
    lr, lc = S // my, S // mx
    nc = n // 2
    origin = _ext_origin(mesh, lr, lc)
    lean, dru, dcu, drt, dct = _halo_depths(cfg, halo)

    if not u_ghosts_fresh:
        u = refresh_ghosts(mesh, u, n, lr, lc, dru, dcu)
    u, uc0, bc = _k1f(u, b, origin, n, cfg, phi, dphi, a)

    if k + 1 < levels.num_sharded:
        # uc0 is the next level's initial iterate (its pre-smoothing reads
        # u-depth ghosts) and bc its right-hand side.
        uc0 = refresh_ghosts(mesh, uc0, nc, lr // 2, lc // 2, dru, dcu)
        bc = refresh_ghosts(mesh, bc, nc, lr // 2, lc // 2, drt, dct)
        uc = uc0
        for i, sub in enumerate(_sub_configs(cfg)):
            uc = _fas_vcycle_pallas(mesh, levels, tail, sub, k + 1, uc, bc,
                                    phi=phi, dphi=dphi, a=a, halo=halo,
                                    u_ghosts_fresh=(i == 0))
        ec = uc - uc0          # owned valid; ghosts refreshed below
    else:
        uc0_full = gather_owned(mesh, uc0)
        bc_full = gather_owned(mesh, bc)
        uc_full = uc0_full
        for sub in _sub_configs(cfg):
            # The replicated tail on the plain operators.
            uc_full = fas_cycle(tail, dataclasses.replace(
                sub, use_kernels=False), uc_full, bc_full, k=k + 1)
        ec = scatter_owned(mesh, uc_full - uc0_full, lr // 2, lc // 2,
                           dtype=u.dtype)

    # K2f reads only the inner (GR/2, GC/2) coarse ghost rings.
    ec = refresh_ghosts(mesh, ec, nc, lr // 2, lc // 2,
                        GR // 2 if lean else GR, GC // 2 if lean else GC)
    if not lean:
        u = refresh_ghosts(mesh, u, n, lr, lc)
    if want_norm:
        u, ss = _k2f(u, b, ec, origin, n, cfg, phi, dphi, a, True)
        ss = L.all_reduce_sum(mesh, ss)
        return u, torch.sqrt(ss).to(torch.float32)
    return _k2f(u, b, ec, origin, n, cfg, phi, dphi, a, False)


def _nl_residual_owned(mesh: GridMesh, u_ext, b_ext, phi, a, n: int,
                       h2: float):
    """The owned region's nonlinear residual (one halo ring) for the
    solve's initial norm; the per-cycle norm rides K2f-local."""
    uo, bo = owned_view(u_ext), owned_view(b_ext)
    if a is None:
        return _n_residual_local(mesh, uo, bo, phi, n, h2)
    # Quasilinear: the four edge fluxes over one halo ring (wrapped
    # mesh-edge ghosts only ever feed masked boundary cells).
    m = L.interior_mask_local(mesh, uo.shape, n, uo.device)
    hx = L.with_halo1(mesh, uo)
    flux = torch.zeros_like(uo)
    for un in (hx[1:-1, 2:], hx[1:-1, :-2], hx[2:, 1:-1], hx[:-2, 1:-1]):
        ae = a(0.5 * (uo + un)).to(uo.dtype)
        flux = flux + ae * (uo - un)
    return torch.where(m, bo - torch.where(m, flux, 0.0), 0.0)


def fas_sharded_solve_pallas(config: MultigridConfig, mesh: GridMesh, *,
                             phi: Optional[Callable] = None,
                             dphi: Optional[Callable] = None,
                             a: Optional[Callable] = None,
                             forcing=4.0, tol: Optional[float] = 1e-8,
                             max_cycles: int = 100,
                             num_cycles: Optional[int] = None, u0=None,
                             replicate_below: int = 256,
                             halo: str = "lean"):
    """Distributed FAS solve on the fused extended-block kernels; every rank
    of ``mesh`` calls it.

    Pointwise family: pass ``phi``/``dphi`` (-Δu + φ(u) = f, Jacobi-Newton).
    Quasilinear family: pass ``a`` (-∇·(a(u)∇u) = f, Picard-Jacobi).  On
    CUDA tensors the kernels carry only ``core.nonlinear``'s
    ``BratuNonlinearity`` (as both ``phi`` and ``dphi``) and
    ``QuadraticCoefficient``; another callable raises ``ValueError`` there.
    The config's smoother must be Jacobi (the nonlinear sweeps are weighted
    Jacobi-Newton or Picard-Jacobi with ``config.omega``).

    Cycles stop at ``num_cycles``, or when the nonlinear residual norm is at
    most ``tol`` times the first, or after two cycles in a row that each
    reduce it by less than 0.9, or after ``max_cycles``.  Returns
    ``(SolveResult, ShardedLevels)``; ``result.u`` is this rank's owned
    (lr, lc) block, ``res_history`` a float32 CPU tensor (NaN past the last
    cycle), the same on every rank.  ``u0``: a starting iterate on the
    global (S0, S0) grid.  The JAX package's ``jit`` has no counterpart
    here."""
    if (a is None) == (phi is None):
        raise ValueError("pass exactly one of phi/dphi (pointwise) or a "
                         "(quasilinear)")
    if tol is None and num_cycles is None:
        raise ValueError("need tol or num_cycles")
    if config.smoother != "jacobi":
        raise ValueError(f"the FAS tier smooths with weighted Jacobi-Newton "
                         f"/ Picard-Jacobi; config.smoother="
                         f"{config.smoother!r} is not taken")
    my, mx = mesh.shape
    levels = pallas_level_sizes(config, mesh.shape,
                                replicate_below=replicate_below)
    if levels.num_sharded < 1:
        raise _no_shardable_level(
            mesh, levels, config.finest_level,
            "dist.fas.fas_sharded_solve (the jnp FAS shard tier, not ported "
            "yet: ROADMAP.md, queue 1 item 16)")
    if a is not None:
        # As the JAX package builds it: `a` also stands in for `da`, which
        # only reporting reads.
        tail = Hierarchy(tuple(QuasilinearFluxOp(n, S, a, a)
                               for (n, S) in levels.sizes), None)
    else:
        tail = build_replicated_tail(levels, config, phi, dphi,
                                     device=mesh.device)
    n0, S0 = levels.sizes[0]
    lr, lc = S0 // my, S0 // mx
    h2 = (1.0 / n0) ** 2
    dt = config.dtype
    fixed = num_cycles is not None
    ncyc = num_cycles if fixed else max_cycles

    b_ext = rhs_ext(mesh, n0, lr, lc, forcing, dt)
    cy, cx = mesh.coords
    if u0 is None:
        blk = torch.zeros((lr, lc), dtype=dt, device=mesh.device)
    else:
        u0 = torch.as_tensor(u0)
        if tuple(u0.shape) != (S0, S0):
            raise ValueError(f"u0 must be the global ({S0}, {S0}) grid, got "
                             f"{tuple(u0.shape)}")
        blk = u0[cy * lr:(cy + 1) * lr, cx * lc:(cx + 1) * lc].to(
            device=mesh.device, dtype=dt)
    u = _extend_local(mesh, blk, n0, lr, lc)
    r0 = np.float32(L.norm2_local(mesh, _nl_residual_owned(
        mesh, u, b_ext, phi, a, n0, h2)).item())
    target = np.float32(tol) * r0 if tol is not None else np.float32(0.0)
    hist = np.full((ncyc + 1,), np.nan, np.float32)
    hist[0] = r0
    i, rnorm, stalls = 0, r0, 0
    while i < ncyc and (fixed or (rnorm > target and stalls < 2)):
        u, rnew_t = _fas_vcycle_pallas(mesh, levels, tail, config, 0, u,
                                       b_ext, phi=phi, dphi=dphi, a=a,
                                       want_norm=True, halo=halo)
        rnew = np.float32(rnew_t.item())
        hist[i + 1] = rnew
        stalls = stalls + 1 if rnew > np.float32(0.9) * rnorm else 0
        rnorm = rnew
        i += 1
    return SolveResult(u=owned_view(u), res_history=torch.from_numpy(hist),
                       iterations=i,
                       converged=bool(rnorm <= target)), levels
