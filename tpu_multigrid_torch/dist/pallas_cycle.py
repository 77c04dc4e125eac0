"""The fused distributed tier: multigrid on ghost-extended blocks.

Each sharded level keeps this rank's block ghost-extended
(:mod:`tpu_multigrid_torch.kernels.local`: ``GR = 16`` rows and ``GC = 256``
columns a side), and a level visit is:

1. a strip-wise ghost refresh of ``u`` (two phases: rows, then the columns
   of the row-refreshed block, so corners arrive without diagonal sends);
2. one K1-local launch (pre-smoothing, residual, full-weighting restriction)
   producing the next level's extended block;
3. the next sharded level, or the gathered residual's replicated coarse
   hierarchy (the replicate-below switch of :mod:`.shard_cycle`);
4. a ghost refresh of the prolonged correction, then one K2-local launch
   (prolongation, correction, post-smoothing, and for the until-tol driver
   the owned residual's sum of squares, added over the mesh).  Under the
   default ``halo="lean"`` schedule ``u`` needs no refresh here: K1 smooths
   the whole extended block, so its inner ghost rings already hold what the
   exchange would deliver (:func:`_halo_depths`), and every other exchange
   sends only the depth the next launch reads.

Received ghost strips are masked to the *global* interior, so wrapped
strips (mesh edges) and physical-boundary cells hold zeros, the invariant
the kernels rely on.

A port of ``tpu_multigrid/dist/pallas_cycle.py`` on ``torch.distributed``:
the code that ran inside ``shard_map`` runs on every rank with the
:class:`.mesh.GridMesh` passed explicitly, the ``lax.while_loop`` is a
Python loop whose stop test reads a norm every rank holds after the
all-reduce (so every rank takes the same branch), and ``result.u`` is this
rank's owned block (:func:`.local_ops.gather_full` assembles the global
array).  The refresh updates a block's ghost zones in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import MultigridConfig
from ..core import ops
from ..core.grids import Hierarchy, coarse_dense_inverse, round_up
from ..core.operators import poisson_op
from ..cycles import SolveResult, _coarsest_solve, _sm
from ..kernels import local as KL
from . import local_ops as L
from .mesh import GridMesh, shift_from_next, shift_from_prev
from .shard_cycle import ShardedLevels, _replicated_cycle

GR, GC = KL.GR, KL.GC

# The JAX package's widest extended block (tpu_multigrid/kernels/local.py
# MAX_C, a TPU on-chip memory bound).  It is kept in the level layout so
# that both packages split a hierarchy into the same sharded and replicated
# levels; the kernels here take any width.
MAX_C = 18 * 1024


# ---------------------------------------------------------------------------
# Ghost-zone plumbing
# ---------------------------------------------------------------------------

def _ext_origin(mesh: GridMesh, lr: int, lc: int) -> Tuple[int, int]:
    """Global coordinates of the extended block's cell (0, 0)."""
    return mesh.coords[0] * lr - GR, mesh.coords[1] * lc - GC


def _mask_strip(strip, oy: int, ox: int, n: int):
    """Zero the strip's cells whose global coordinates fall outside the
    interior; (oy, ox) are those of its cell (0, 0)."""
    r, c = strip.shape
    return torch.where(KL._masks(r, c, (oy, ox), n, strip.device)[0], strip,
                       0.0)


def refresh_ghosts(mesh: GridMesh, x, n: int, lr: int, lc: int,
                   dr: int = GR, dc: int = GC):
    """Refill the ghost zones of the extended block ``x`` from the
    neighbours, in place; returns ``x``.

    Strips only.  Two phases (rows, then columns including the refreshed
    ghost rows) so corner ghosts arrive in two hops.  ``dr`` / ``dc`` bound
    the exchanged depth to the *inner* ``dr`` rows / ``dc`` columns of each
    ghost zone, the only part whose values can reach valid kernel outputs;
    the outer rest keeps what the last launch wrote there."""
    R, C = x.shape
    dr, dc = min(dr, GR), min(dc, GC)
    oy, ox = _ext_origin(mesh, lr, lc)

    top = shift_from_prev(mesh, x[R - GR - dr:R - GR], 0)
    bot = shift_from_next(mesh, x[GR:GR + dr], 0)
    x[GR - dr:GR] = _mask_strip(top, oy + GR - dr, ox, n)
    x[R - GR:R - GR + dr] = _mask_strip(bot, oy + R - GR, ox, n)

    lf = shift_from_prev(mesh, x[:, C - GC - dc:C - GC], 1)
    rt = shift_from_next(mesh, x[:, GC:GC + dc], 1)
    x[:, GC - dc:GC] = _mask_strip(lf, oy, ox + GC - dc, n)
    x[:, C - GC:C - GC + dc] = _mask_strip(rt, oy, ox + C - GC, n)
    return x


def _halo_depths(cfg: MultigridConfig, halo: str):
    """(lean, dru, dcu, drt, dct): the ghost-exchange plan of a level visit.

    ``halo="lean"`` sends only the depth the next launch reads and skips
    the pre-K2 refresh of u: after K1's ``s1`` smoothing steps over the
    whole extended block, the inner ``GR - s1`` ghost rings of u' hold
    exactly what a refresh would deliver, and K2 reads ``s2 <= GR - s1``
    of them.  K1's restricted residual needs its inputs exact to depth
    ``s1 + 2``, K2 needs u' exact to ``s2``: u exact to
    ``s1 + max(2, s2)``, rounded up to the (8, 128) quanta the JAX package
    exchanges.  ``halo="full"`` refreshes every zone to full depth before
    every launch.  Both give the same iterates, bitwise."""
    mult = 2 if cfg.smoother == "rbgs" else 1
    s1, s2 = mult * cfg.nu1, mult * cfg.nu2
    need = s1 + max(2, s2)
    lean = halo == "lean" and need <= GR
    if not lean:
        return False, GR, GC, GR, GC
    dru = min(GR, -(-need // 8) * 8)
    dcu = min(GC, -(-need // 128) * 128)
    return True, dru, dcu, dru, dcu


def owned_view(x):
    """(R, C) extended block -> its (lr, lc) owned region (a view)."""
    R, C = x.shape
    return x[GR:R - GR, GC:C - GC]


def gather_owned(mesh: GridMesh, x):
    """Every rank's owned region assembled into the full (S, S) array."""
    return L.gather_full(mesh, owned_view(x))


def scatter_owned(mesh: GridMesh, full, lr: int, lc: int, dtype=None):
    """This rank's (lr, lc) block of a replicated array in a fresh extended
    block, ghosts zero (the caller refreshes them)."""
    dtype = dtype or full.dtype
    oy, ox = mesh.coords[0] * lr, mesh.coords[1] * lc
    ext = full.new_zeros((lr + 2 * GR, lc + 2 * GC), dtype=dtype)
    ext[GR:GR + lr, GC:GC + lc] = full[oy:oy + lr, ox:ox + lc]
    return ext


def _extend_local(mesh: GridMesh, blk, n: int, lr: int, lc: int):
    """An (lr, lc) owned block in an extended block with refreshed
    ghosts."""
    ext = blk.new_zeros((lr + 2 * GR, lc + 2 * GC))
    ext[GR:GR + lr, GC:GC + lc] = blk
    return refresh_ghosts(mesh, ext, n, lr, lc)


# ---------------------------------------------------------------------------
# Level sizing
# ---------------------------------------------------------------------------

def _layout_supported(R: int, C: int, steps: int, dtype) -> bool:
    """``kernels.local.supported_local`` with the JAX package's column cap
    (:data:`MAX_C`)."""
    return C <= MAX_C and KL.supported_local(R, C, steps, dtype)


def pallas_level_sizes(config: MultigridConfig, mesh_shape: Tuple[int, int],
                       *, replicate_below: int = 256) -> ShardedLevels:
    """The (n, S) of every level and how many of the finest run sharded:
    local rows a multiple of 16 and columns of 256, both at least
    ``replicate_below``, and a block the extended-block kernels take.  The
    finest S is rounded up to a multiple of 1024 when that costs at most
    10 % more, so that more levels halve onto the quanta."""
    my, mx = mesh_shape
    n0 = 2 ** config.finest_level
    quantum = math.lcm(256, 16 * my, 256 * mx)
    S0 = round_up(n0 + 1, quantum)
    S0_big = round_up(n0 + 1, math.lcm(quantum, 1024))
    if S0_big <= 1.10 * S0:
        S0 = S0_big
    mult = 2 if config.smoother == "rbgs" else 1
    steps = mult * max(config.nu1, config.nu2, 1) + 1
    sizes = []
    num_sharded = 0
    S = S0
    for i, lvl in enumerate(range(config.finest_level,
                                  config.coarsest_level - 1, -1)):
        n = 2 ** lvl
        lr, lc = S // my, S // mx
        ok = (num_sharded == i and S % my == 0 and S % mx == 0
              and lr % 16 == 0 and lc % 256 == 0
              and min(lr, lc) >= replicate_below and S >= n + 1
              and _layout_supported(lr + 2 * GR, lc + 2 * GC, steps,
                                    config.dtype)
              and (S // 2) % my == 0 and (S // 2) % mx == 0)
        if ok:
            sizes.append((n, S))
            num_sharded += 1
            S //= 2
        elif num_sharded == i:
            sizes.append((n, max(S, n + 1)))
        else:
            sizes.append((n, n + 1))
    num_sharded = min(num_sharded, len(sizes) - 1)
    return ShardedLevels(tuple(sizes), num_sharded)


def build_pallas_poisson(config: MultigridConfig, mesh_shape, *,
                         replicate_below: int = 256, device=None):
    """(levels, hierarchy) of the fused tier on an ``mesh_shape`` grid of
    ranks; the coarse inverse lives on ``device``."""
    levels = pallas_level_sizes(config, tuple(mesh_shape),
                                replicate_below=replicate_below)
    hops = tuple(poisson_op(n, S) for (n, S) in levels.sizes)
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = coarse_dense_inverse(hops[-1], device=device)
    return levels, Hierarchy(hops, coarse_inv)


# ---------------------------------------------------------------------------
# The fused distributed cycle
# ---------------------------------------------------------------------------

def _vcycle_pallas(mesh: GridMesh, levels: ShardedLevels, hier: Hierarchy,
                   cfg: MultigridConfig, k: int, u, b,
                   want_norm: bool = False, halo: str = "lean",
                   u_ghosts_fresh: bool = False):
    """V/W/F-cycle at sharded level k on extended blocks.

    ``b``'s ghosts must be valid on entry.  Returns u' (owned region valid,
    ghosts stale), and with ``want_norm`` also the global post-cycle
    residual norm.  ``u_ghosts_fresh``: the caller guarantees ``u``'s ghost
    rings hold what a refresh would deliver, so the pre-K1 exchange is
    skipped (a zero guess, or a block :func:`_extend_local` just
    refreshed)."""
    my, mx = mesh.shape
    n, S = levels.sizes[k]
    lr, lc = S // my, S // mx
    origin = _ext_origin(mesh, lr, lc)
    sm1, om1 = _sm(cfg, cfg.nu1)
    sm2, om2 = _sm(cfg, cfg.nu2)
    lean, dru, dcu, drt, dct = _halo_depths(cfg, halo)

    if not u_ghosts_fresh:
        u = refresh_ghosts(mesh, u, n, lr, lc, dru, dcu)
    u, rc = KL.smooth_restrict_ext(u, b, origin, n, cfg.nu1, sm1, om1)

    recurse_cnt = 2 if cfg.cycle in ("W", "F") else 1
    if k + 1 < levels.num_sharded:
        rc = refresh_ghosts(mesh, rc, n // 2, lr // 2, lc // 2, drt, dct)
        ec = torch.zeros_like(rc)
        for i in range(recurse_cnt):
            sub = cfg if (cfg.cycle != "F" or i == 0) else \
                dataclasses.replace(cfg, cycle="V")
            ec = _vcycle_pallas(mesh, levels, hier, sub, k + 1, ec, rc,
                                halo=halo, u_ghosts_fresh=(i == 0))
    else:
        rc_full = gather_owned(mesh, rc)
        Sr = levels.sizes[k + 1][1]
        assert rc_full.shape[-1] == Sr, (rc_full.shape, Sr)
        ec_full = torch.zeros_like(rc_full)
        for i in range(recurse_cnt):
            sub = cfg if (cfg.cycle != "F" or i == 0) else \
                dataclasses.replace(cfg, cycle="V")
            if k + 1 == len(levels.sizes) - 1:
                ec_full = _coarsest_solve(hier, sub, ec_full, rc_full)
            else:
                ec_full = _replicated_cycle(hier, sub, k + 1, ec_full,
                                            rc_full)
        ec = scatter_owned(mesh, ec_full, lr // 2, lc // 2, dtype=u.dtype)

    # K2 reads only the inner (GR/2, GC/2) coarse ghost rings.
    ec = refresh_ghosts(mesh, ec, n // 2, lr // 2, lc // 2,
                        GR // 2 if lean else GR, GC // 2 if lean else GC)
    if not lean:
        u = refresh_ghosts(mesh, u, n, lr, lc)
    if want_norm:
        u, ss = KL.prolong_smooth_ext(u, b, ec, origin, n, cfg.nu2, sm2, om2,
                                      want_resnorm=True)
        ss = L.all_reduce_sum(mesh, ss)
        return u, torch.sqrt(ss).to(torch.float32)
    return KL.prolong_smooth_ext(u, b, ec, origin, n, cfg.nu2, sm2, om2)


def _fmg_pallas(mesh: GridMesh, levels: ShardedLevels, hier: Hierarchy,
                cfg: MultigridConfig, b_ext, halo: str = "lean"):
    """Full multigrid on the fused tier.  The right-hand side chain
    restricts rank-locally on owned views (one pass; the plain local ops);
    each level's ``nu0`` correction cycles run through K1-local / K2-local
    (:func:`_vcycle_pallas`)."""
    my, mx = mesh.shape
    nlev = len(levels.sizes)
    ns = levels.num_sharded

    bs_ext = [b_ext]
    for k in range(ns - 1):
        n, S = levels.sizes[k]
        r_own = L.restrict_fw_local(mesh, owned_view(bs_ext[-1]), n)
        bs_ext.append(_extend_local(mesh, r_own, n // 2, S // 2 // my,
                                    S // 2 // mx))
    bs_full = [L.gather_full(mesh, L.restrict_fw_local(
        mesh, owned_view(bs_ext[-1]), levels.sizes[ns - 1][0]))]
    for k in range(ns, nlev - 1):
        bs_full.append(ops.restrict_fw(bs_full[-1], levels.sizes[k][0],
                                       levels.sizes[k + 1][1]))

    u_full = torch.zeros_like(bs_full[-1])
    u_full = _coarsest_solve(hier, cfg, u_full, bs_full[-1])
    for k in range(nlev - 2, ns - 1, -1):
        u_full = ops.prolong(u_full, levels.sizes[k + 1][0],
                             levels.sizes[k][1])
        for _ in range(cfg.nu0):
            u_full = _replicated_cycle(hier, cfg, k, u_full, bs_full[k - ns])

    n, S = levels.sizes[ns - 1]
    lr, lc = S // my, S // mx
    u_ext = scatter_owned(mesh, ops.prolong(u_full, levels.sizes[ns][0], S),
                          lr, lc, dtype=b_ext.dtype)
    for _ in range(cfg.nu0):
        u_ext = _vcycle_pallas(mesh, levels, hier, cfg, ns - 1, u_ext,
                               bs_ext[ns - 1], halo=halo)
    for k in range(ns - 2, -1, -1):
        n, S = levels.sizes[k]
        u_own = L.prolong_local(mesh, owned_view(u_ext),
                                levels.sizes[k + 1][0])
        u_ext = _extend_local(mesh, u_own, n, S // my, S // mx)
        for j in range(cfg.nu0):
            u_ext = _vcycle_pallas(mesh, levels, hier, cfg, k, u_ext,
                                   bs_ext[k], halo=halo,
                                   u_ghosts_fresh=(j == 0))
    return u_ext


def rhs_ext(mesh: GridMesh, n0: int, lr: int, lc: int, forcing, dtype):
    """This rank's extended right-hand side block: ``forcing(x, y) h^2``
    (a constant, or a callable of torch coordinate tensors) on the owned
    interior nodes, ghosts refreshed."""
    R, C = lr + 2 * GR, lc + 2 * GC
    oy, ox = _ext_origin(mesh, lr, lc)
    dev = mesh.device
    gi = torch.arange(R, device=dev) + oy
    gj = torch.arange(C, device=dev) + ox
    cy, cx = mesh.coords
    inter = (((gi >= 1) & (gi <= n0 - 1))[:, None]
             & ((gj >= 1) & (gj <= n0 - 1))[None, :])
    owned = (((gi >= cy * lr) & (gi < (cy + 1) * lr))[:, None]
             & ((gj >= cx * lc) & (gj < (cx + 1) * lc))[None, :])
    h2 = (1.0 / n0) ** 2
    if callable(forcing):
        h = torch.tensor(1.0 / n0, dtype=dtype, device=dev)
        x = (gj.to(dtype) * h)[None, :].expand(R, C)
        y = (gi.to(dtype) * h)[:, None].expand(R, C)
        vals = forcing(x, y).to(dtype) * torch.tensor(h2, dtype=dtype,
                                                      device=dev)
    else:
        vals = torch.full((R, C), float(forcing) * h2, dtype=dtype,
                          device=dev)
    b_ext = torch.where(inter & owned, vals, torch.zeros((), dtype=dtype,
                                                         device=dev))
    return refresh_ghosts(mesh, b_ext, n0, lr, lc)


def _no_shardable_level(mesh: GridMesh, levels, finest_level: int, alt: str):
    return ValueError(
        f"no level satisfies the fused tier's shard constraints for mesh "
        f"{mesh.shape} at finest_level={finest_level}; use {alt} instead "
        f"(levels: {levels.sizes})")


def sharded_solve_pallas(config: MultigridConfig, mesh: GridMesh, *,
                         forcing=4.0, u0=None, use_fmg: bool = False,
                         tol: float = 1e-5, max_cycles: int = 100,
                         num_cycles: Optional[int] = None,
                         replicate_below: int = 256, halo: str = "lean"):
    """Distributed Poisson solve on the fused tier; every rank of ``mesh``
    calls it.

    Returns ``(SolveResult, ShardedLevels)``; ``result.u`` is this rank's
    owned (lr, lc) block (:func:`.local_ops.gather_full` assembles the
    global (S0, S0) array), ``res_history`` a float32 CPU tensor, the same
    on every rank.  ``u0``: a starting iterate on the global (S0, S0)
    grid.  ``halo``: ``"lean"`` (the default) or ``"full"``
    (:func:`_halo_depths`), bitwise the same iterates.  The JAX package's
    ``jit`` has no counterpart here."""
    my, mx = mesh.shape
    levels, hier = build_pallas_poisson(config, mesh.shape,
                                        replicate_below=replicate_below,
                                        device=mesh.device)
    if levels.num_sharded < 1:
        raise _no_shardable_level(mesh, levels, config.finest_level,
                                  "a single-device solve")
    n0, S0 = levels.sizes[0]
    lr, lc = S0 // my, S0 // mx
    dt = config.dtype
    b_ext = rhs_ext(mesh, n0, lr, lc, forcing, dt)

    if use_fmg:
        u = _fmg_pallas(mesh, levels, hier, config, b_ext, halo=halo)
    else:
        cy, cx = mesh.coords
        if u0 is None:
            blk = torch.zeros((lr, lc), dtype=dt, device=mesh.device)
        else:
            u0 = torch.as_tensor(u0)
            if tuple(u0.shape) != (S0, S0):
                raise ValueError(f"u0 must be the global ({S0}, {S0}) grid, "
                                 f"got {tuple(u0.shape)}")
            blk = u0[cy * lr:(cy + 1) * lr, cx * lc:(cx + 1) * lc].to(
                device=mesh.device, dtype=dt)
        u = _extend_local(mesh, blk, n0, lr, lc)
    r0_t = L.norm2_local(mesh, L.residual_local(mesh, owned_view(u),
                                                owned_view(b_ext), n0))
    r0 = np.float32(r0_t.item())
    target = np.float32(tol) * r0
    ncyc = num_cycles if num_cycles is not None else max_cycles
    hist = np.full((ncyc + 1,), np.nan, np.float32)
    hist[0] = r0
    i, rnorm, prev = 0, r0, np.float32(np.inf)
    while i < ncyc and (num_cycles is not None
                        or (rnorm > target
                            and rnorm < np.float32(0.9) * prev)):
        u, rnew = _vcycle_pallas(mesh, levels, hier, config, 0, u, b_ext,
                                 want_norm=True, halo=halo)
        prev, rnorm = rnorm, np.float32(rnew.item())
        hist[i + 1] = rnorm
        i += 1
    return SolveResult(u=owned_view(u), res_history=torch.from_numpy(hist),
                       iterations=i, converged=bool(rnorm <= target)), levels
