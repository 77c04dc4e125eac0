"""Distributed compensated refinement on the fused tier.

The outer iterate is a double-single pair or triple-single triple of
ghost-extended blocks; each iteration's correction comes from one fused
V-cycle (:func:`.pallas_cycle._vcycle_pallas`) on the compensated residual,
or, with ``ds_levels``, from a cycle whose finest levels keep their
corrections double-single (:func:`_cycle_ds_pallas`, the distributed twin
of ``precision.cycle_ds``).  The compensated residuals, the exact-pair
prolongation and the compensated adds are one launch each
(:mod:`tpu_multigrid_torch.kernels.localref`), the adds in place.  On a
(1, 1) mesh this runs the whole machinery on one device: the path the JAX
package took for its one-chip 16385^2 record.

A port of ``tpu_multigrid/dist/refine_pallas.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import precision
from ..config import MultigridConfig
from ..core.grids import Hierarchy
from ..cycles import SolveResult, _coarsest_solve, _sm
from ..kernels import local as KL
from ..kernels import localref as KR
from . import local_ops as L
from .mesh import GridMesh
from .pallas_cycle import (_ext_origin, _halo_depths, _no_shardable_level,
                           _replicated_cycle, _vcycle_pallas,
                           build_pallas_poisson, gather_owned, owned_view,
                           pallas_level_sizes, refresh_ghosts, rhs_ext,
                           scatter_owned)
from .shard_cycle import ShardedLevels

GR, GC = KL.GR, KL.GC


@dataclasses.dataclass
class RefinedSolveResult(SolveResult):
    """A refined solve's result: ``u`` is the owned block of the iterate's
    leading component, ``components`` the owned blocks of all of them
    (hi, [mid,] lo), whose sum is the iterate."""

    components: Tuple = ()


def _cycle_ds_pallas(mesh: GridMesh, levels: ShardedLevels, hier: Hierarchy,
                     cfg: MultigridConfig, k: int, r_ext, ds_levels: int,
                     halo: str):
    """One fused V-cycle on A e = r returning e as a double-single pair of
    extended blocks (owned regions valid, ghosts stale).

    ``r_ext``'s ghosts must be fresh to K1's depth.  K1 pre-smooths from
    zero and restricts; the sub-correction comes back as a ds pair and is
    prolonged through ``prolong_pair_ext`` (an exact error term); the
    post-smoothing runs in delta form against the compensated defect."""
    my, mx = mesh.shape
    n, S = levels.sizes[k]
    lr, lc = S // my, S // mx
    origin = _ext_origin(mesh, lr, lc)
    sm1, om1 = _sm(cfg, cfg.nu1)
    sm2, om2 = _sm(cfg, cfg.nu2)
    lean, dru, dcu, drt, dct = _halo_depths(cfg, halo)

    e0, rc = KL.smooth_restrict_ext(torch.zeros_like(r_ext), r_ext, origin,
                                    n, cfg.nu1, sm1, om1)

    if k + 1 < levels.num_sharded:
        rc = refresh_ghosts(mesh, rc, n // 2, lr // 2, lc // 2, drt, dct)
    if k + 1 < min(ds_levels, levels.num_sharded):
        ec = _cycle_ds_pallas(mesh, levels, hier, cfg, k + 1, rc, ds_levels,
                              halo)
    elif k + 1 < levels.num_sharded:
        ec = (_vcycle_pallas(mesh, levels, hier, cfg, k + 1,
                             torch.zeros_like(rc), rc, halo=halo,
                             u_ghosts_fresh=True),)
    else:
        rc_full = gather_owned(mesh, rc)
        ec_full = torch.zeros_like(rc_full)
        if k + 1 == len(levels.sizes) - 1:
            ec_full = _coarsest_solve(hier, cfg, ec_full, rc_full)
        else:
            ec_full = _replicated_cycle(hier, cfg, k + 1, ec_full, rc_full)
        ec = (scatter_owned(mesh, ec_full, lr // 2, lc // 2,
                            dtype=r_ext.dtype),)
    if len(ec) == 1:
        ec += (torch.zeros_like(ec[0]),)

    # The exact-pair prolongation reads the coarse pair to (GR/2, GC/2).
    ec_hi, ec_lo = (refresh_ghosts(mesh, c, n // 2, lr // 2, lc // 2, GR // 2,
                                   GC // 2) for c in ec)
    p_hi, p_lo = KR.prolong_pair_ext(ec_hi, ec_lo, origin, n)
    e_hi, e_lo = KR.comp_add_ext((p_hi, p_lo), (e0,))

    # Delta-form post-smoothing against the compensated defect: the
    # residual reads one fresh ring of the pair (r_ext's ghosts are still
    # fresh), the smoothing s2 rings of d0.
    e_hi = refresh_ghosts(mesh, e_hi, n, lr, lc, 8, 128)
    e_lo = refresh_ghosts(mesh, e_lo, n, lr, lc, 8, 128)
    d0 = KR.ds_residual_ext(r_ext, e_hi, e_lo, origin, n)
    d0 = refresh_ghosts(mesh, d0, n, lr, lc, dru, dcu)
    delta = KL.smooth_ext(torch.zeros_like(d0), d0, origin, n, cfg.nu2, sm2,
                          om2)
    return KR.comp_add_ext((e_hi, e_lo), (delta,))


def refined_sharded_solve_pallas(config: MultigridConfig, mesh: GridMesh, *,
                                 forcing=4.0, tol: Optional[float] = 1e-8,
                                 max_iters: int = 60,
                                 stall_factor: float = 0.9,
                                 num_cycles: Optional[int] = None,
                                 ds_levels: int = 0, ts: bool = False,
                                 replicate_below: int = 256,
                                 halo: str = "lean", prebuilt=None):
    """Distributed compensated refinement on the fused tier; every rank of
    ``mesh`` calls it.

    A ds pair (or ts triple with ``ts``) outer iterate; each iteration adds
    one fused V-cycle's correction (double-single on the finest
    ``ds_levels`` sharded levels) and takes the compensated residual.  It
    stops at ``num_cycles`` iterations, or when the residual norm is below
    ``tol`` times the first or falls by less than ``stall_factor`` in an
    iteration, or after ``max_iters``.  Returns ``(RefinedSolveResult,
    ShardedLevels)``; ``result.u`` and ``result.components`` are this
    rank's owned blocks.  Constant-coefficient Poisson only.

    ``prebuilt=(levels, hier)`` reuses a :func:`.pallas_cycle.
    build_pallas_poisson` result of the same mesh shape and
    ``replicate_below`` across solves; one whose layout is not this
    solve's raises ``ValueError``.  The JAX package's ``jit`` and
    ``return_runner`` (a traced program for reuse) have no counterpart
    here: each call runs eagerly."""
    precision._check_modes(tol, num_cycles)
    my, mx = mesh.shape
    cfg = dataclasses.replace(config, cycle="V")
    if prebuilt is not None:
        levels, hier = prebuilt
        want = pallas_level_sizes(cfg, mesh.shape,
                                  replicate_below=replicate_below)
        got = tuple((op.n, op.S) for op in hier.levels)
        if levels != want or got != want.sizes:
            raise ValueError(
                f"prebuilt=(levels, hier) does not match this solve's layout"
                f": levels {levels.sizes} ({levels.num_sharded} sharded), "
                f"hierarchy {got}, against {want.sizes} ({want.num_sharded} "
                f"sharded) for finest_level={cfg.finest_level} on mesh "
                f"{mesh.shape} with replicate_below={replicate_below}")
    else:
        levels, hier = build_pallas_poisson(cfg, mesh.shape,
                                            replicate_below=replicate_below,
                                            device=mesh.device)
    if levels.num_sharded < 1:
        raise _no_shardable_level(mesh, levels, cfg.finest_level,
                                  "a single-device refined solve")
    n0, S0 = levels.sizes[0]
    lr, lc = S0 // my, S0 // mx
    if not KR.supported_local_ref(lr + 2 * GR, lc + 2 * GC, cfg.dtype):
        raise ValueError(f"local block ({lr}x{lc}) outside the compensated "
                         "kernels' envelope (float32, 16/256 quanta)")
    origin = _ext_origin(mesh, lr, lc)
    _, dru, dcu, _, _ = _halo_depths(cfg, halo)

    b_ext = rhs_ext(mesh, n0, lr, lc, forcing, cfg.dtype)

    def owned_norm(r_ext):
        return np.float32(L.norm2_local(mesh, owned_view(r_ext)).item())

    def resid(comps):
        # The components' ghosts must be fresh to 1 ring (quanta 8/128).
        comps = tuple(refresh_ghosts(mesh, c, n0, lr, lc, 8, 128)
                      for c in comps)
        residual = KR.ts_residual_ext if ts else KR.ds_residual_ext
        return residual(b_ext, *comps, origin, n0)

    comps = tuple(torch.zeros_like(b_ext) for _ in range(3 if ts else 2))
    r = b_ext   # its ghosts are fresh
    loop = precision._RefinementLoop(owned_norm(r), tol, stall_factor,
                                     num_cycles, max_iters)
    while loop.running():
        if ds_levels > 0:
            e = _cycle_ds_pallas(mesh, levels, hier, cfg, 0, r, ds_levels,
                                 halo)
        else:
            e = (_vcycle_pallas(mesh, levels, hier, cfg, 0,
                                torch.zeros_like(r), r, halo=halo,
                                u_ghosts_fresh=True),)
        comps = KR.comp_add_ext(comps, e)
        r = resid(comps)
        # The next K1 launch reads r to the smoothing depth.
        r = refresh_ghosts(mesh, r, n0, lr, lc, dru, dcu)
        loop.record(owned_norm(r))
    hist, iters, conv = loop.outcome()
    owned = tuple(owned_view(c) for c in comps)
    return RefinedSolveResult(u=owned[0], res_history=hist,
                              iterations=iters, converged=conv,
                              components=owned), levels
