"""The fused distributed 3D tier: multigrid on ghost-extended 3D blocks.

The 3D twin of :mod:`.pallas_cycle`.  An (S, S, Sx) grid is decomposed
(gz, gy) over a (mz, my) grid of ranks, x whole on every rank; each sharded
level keeps this rank's block ghost-extended (``GZ3 = GY3 = 16`` planes and
rows a side, none in x), and a level visit is:

1. a strip-wise ghost refresh of ``u`` (two phases: z, then y of the
   z-refreshed block, so corners arrive without diagonal sends);
2. one K1_3-ext launch (pre-smoothing, residual, full-weighting
   restriction) producing the next level's extended block, K1v_3-ext on a
   variable-coefficient level (:mod:`tpu_multigrid_torch.kernels.
   transfer3d`, ``.vartransfer3d``);
3. the next sharded level, or the gathered residual's replicated coarse
   hierarchy on the plain torch operators;
4. a ghost refresh of the prolonged correction, then one K2_3-local launch
   (prolongation, correction, post-smoothing, and for the until-tol driver
   the owned residual's sum of squares, added over the mesh), K2v_3-local on
   a variable-coefficient level.  Under ``halo="lean"`` every exchange
   sends only the depth the next launch reads and ``u`` needs no refresh
   before K2 (:func:`_halo_depths3`).

Received strips are masked to the *global* interior, so wrapped strips and
physical-boundary cells hold zeros.  The variable-coefficient solvers keep
each sharded level's coefficient stack as this rank's ghost-inclusive block
(:func:`ext_coef_block3`): coefficients are static, so the ghost shells are
filled once, at set-up, and never exchanged.

A port of ``tpu_multigrid/dist/pallas_cycle3.py`` on ``torch.distributed``,
as :mod:`.pallas_cycle` is of its 2D twin: the code that ran inside
``shard_map`` runs on every rank with the :class:`.mesh.GridMesh` passed
explicitly, the ``lax.while_loop`` is a Python loop whose stop test reads a
norm every rank holds after the all-reduce, ``result.u`` is this rank's
owned (lz, ly, Sx) block, and the refresh updates a block's ghosts in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import MultigridConfig
from ..core.grids import Hierarchy, coarse_dense_inverse, round_up
from ..core.operators import (ConstStencilOp3D, VarStencilOp3D,
                              diffusion_op3_host)
from ..cycles import SolveResult, _coarsest_solve, _sm
from ..kernels import transfer3d as KT3
from ..kernels import vartransfer3d as KV3
from ..kernels.stencil3d import masks3
from ..problems.convection3d import Directional7Op, convection_diffusion_op3
from ..problems.diffusion3d import (_np_dtype, _with_shift3,
                                    cell_coefficients3, coarsen_cells3)
from .local_ops import gather_full, norm2_local
from .mesh import (GridMesh, all_reduce_sum, shift_from_next,
                   shift_from_prev)
from .shard_cycle import _replicated_cycle

GZ3 = 16      # ghost planes a side (even; >= steps + 2)
GY3 = 16      # ghost rows a side (a multiple of 16)
GHOST3 = (GZ3, GY3)


# ---------------------------------------------------------------------------
# Ghost plumbing
# ---------------------------------------------------------------------------

def _ext_origin3(mesh: GridMesh, lz: int, ly: int) -> Tuple[int, int]:
    """Global (z, y) of the extended block's cell (0, 0, 0)."""
    return mesh.coords[0] * lz - GZ3, mesh.coords[1] * ly - GY3


def _mask_strip3(strip, oz: int, oy: int, n: int):
    """Zero the strip's cells outside the global interior; (oz, oy) are
    those of its cell (0, 0, 0)."""
    live = masks3(strip.shape, n, strip.device, (oz, oy))[0]
    return torch.where(live, strip, 0.0)


def refresh_ghosts3(mesh: GridMesh, x, n: int, lz: int, ly: int,
                    dz: int = GZ3, dy: int = GY3):
    """Refill the z and y ghost shells of the extended block ``x`` from the
    neighbours, in place; returns ``x``.

    Strips only: z first, then y of the z-refreshed block, so corners
    arrive in two hops.  ``dz`` / ``dy`` bound the exchange to the inner
    ``dz`` planes / ``dy`` rows of each shell, the only part that can reach
    valid kernel outputs; the outer rest keeps what the last launch wrote
    there."""
    Rz, Ry, _ = x.shape
    dz, dy = min(dz, GZ3), min(dy, GY3)
    oz, oy = _ext_origin3(mesh, lz, ly)

    top = shift_from_prev(mesh, x[Rz - GZ3 - dz:Rz - GZ3], 0)
    bot = shift_from_next(mesh, x[GZ3:GZ3 + dz], 0)
    x[GZ3 - dz:GZ3] = _mask_strip3(top, oz + GZ3 - dz, oy, n)
    x[Rz - GZ3:Rz - GZ3 + dz] = _mask_strip3(bot, oz + Rz - GZ3, oy, n)

    lf = shift_from_prev(mesh, x[:, Ry - GY3 - dy:Ry - GY3], 1)
    rt = shift_from_next(mesh, x[:, GY3:GY3 + dy], 1)
    x[:, GY3 - dy:GY3] = _mask_strip3(lf, oz, oy + GY3 - dy, n)
    x[:, Ry - GY3:Ry - GY3 + dy] = _mask_strip3(rt, oz, oy + Ry - GY3, n)
    return x


def _halo_depths3(cfg: MultigridConfig, halo: str):
    """(lean, dz, dy): the 3D ghost-exchange plan of a level visit, the 2D
    :func:`.pallas_cycle._halo_depths` accounting on the (2, 8) quanta the
    JAX package exchanges.  ``halo="full"`` refreshes every shell to full
    depth before every launch; both give the same iterates, bitwise."""
    mult = 2 if cfg.smoother == "rbgs" else 1
    s1, s2 = mult * cfg.nu1, mult * cfg.nu2
    need = s1 + max(2, s2)
    lean = halo == "lean" and need <= min(GZ3, GY3)
    if not lean:
        return False, GZ3, GY3
    return True, min(GZ3, -(-need // 2) * 2), min(GY3, -(-need // 8) * 8)


def owned_view3(x):
    """(Rz, Ry, Sx) extended block -> its (lz, ly, Sx) owned region (a
    view)."""
    Rz, Ry, _ = x.shape
    return x[GZ3:Rz - GZ3, GY3:Ry - GY3]


def gather_owned3(mesh: GridMesh, x):
    """Every rank's owned region assembled into the global array."""
    return gather_full(mesh, owned_view3(x))


def scatter_owned3(mesh: GridMesh, full, lz: int, ly: int, dtype=None):
    """This rank's (lz, ly, Sx) block of a replicated array in a fresh
    extended block, ghosts zero (the caller refreshes them)."""
    dtype = dtype or full.dtype
    oz, oy = mesh.coords[0] * lz, mesh.coords[1] * ly
    ext = full.new_zeros((lz + 2 * GZ3, ly + 2 * GY3, full.shape[-1]),
                         dtype=dtype)
    ext[GZ3:GZ3 + lz, GY3:GY3 + ly] = full[oz:oz + lz, oy:oy + ly]
    return ext


# ---------------------------------------------------------------------------
# Level sizing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PallasLevels3:
    """The (n, S, Sx) of every level, finest first, and how many of the
    finest run sharded."""
    sizes: Tuple[Tuple[int, int, int], ...]
    num_sharded: int


# The JAX package's on-chip window budgets of its 3D level-visit kernels
# (tpu_multigrid/kernels/stencil3d.py WINDOW_BYTES, vartransfer3d.py
# VAR_WINDOW_BYTES / DIR_WINDOW_BYTES, TPU memory bounds).  Kept in the
# level layout (:func:`_tpu_tiling_exists`) so that both packages split a
# hierarchy into the same sharded and replicated levels; the kernels here
# take any block the quanta allow.
WINDOW_BYTES = 10 * 2 ** 20
VAR_WINDOW_BYTES = 5 * 2 ** 20
DIR_WINDOW_BYTES = 7 * 2 ** 19


def _var_budget(nplanes: int) -> int:
    return VAR_WINDOW_BYTES if nplanes <= 4 else DIR_WINDOW_BYTES


def _tpu_tiling_exists(shape, H: int, budget: int) -> bool:
    """Whether the JAX package's K1_3 tiles an f32 ``shape`` with halo
    ``H`` under ``budget`` bytes a window (``tpu_multigrid/kernels/
    transfer3d.py::_tiles_k1`` returning a tiling), in its arithmetic."""
    Sz, Sy, Sx = shape
    rows = budget // (round_up(Sx, 128) * 4)
    HZ, HY = round_up(H, 2), 16
    if rows >= Sz * Sy:
        return True
    inf = float("inf")
    tz_full, red_full = 0, inf
    if rows >= Sy * (2 * HZ + 2):
        tz_full = min((rows // Sy - 2 * HZ) // 2 * 2, Sz - 2 * HZ, Sz)
        red_full = (tz_full + 2 * HZ) / tz_full if tz_full >= 2 else inf
    a = HZ / HY
    disc = (2 * HY * a + 2 * HZ) ** 2 + 4 * a * rows
    ty = int((-(2 * HY * a + 2 * HZ) + math.sqrt(disc)) / (2 * a))
    ty = min(round_up(ty, 16) - 16, Sy - 2 * HY) // 16 * 16
    tz, red_two = 0, inf
    if ty >= 16:
        tz = min((rows // (ty + 2 * HY) - 2 * HZ) // 2 * 2, Sz - 2 * HZ)
        red_two = ((tz + 2 * HZ) * (ty + 2 * HY)) / (tz * ty) if tz >= 2 \
            else inf
    return (tz_full if red_full <= red_two else tz) >= 2


def _level_sizes3(config: MultigridConfig, mesh_shape, replicate_below: int,
                  takes) -> PallasLevels3:
    """The layout of JAX's ``pallas_level_sizes3`` with ``takes(shape_l,
    shape_lc, steps)`` as the kernels' gate: local z even, local y a
    multiple of 16, both halvable onto the mesh."""
    mz, my = mesh_shape
    n0 = 2 ** config.finest_level
    S0 = round_up(n0 + 1, math.lcm(4 * mz, 32 * my, 16))
    mult = 2 if config.smoother == "rbgs" else 1
    steps = mult * max(config.nu1, config.nu2, 1)
    sizes: List[Tuple[int, int, int]] = []
    num_sharded = 0
    S = S0
    for i, lvl in enumerate(range(config.finest_level,
                                  config.coarsest_level - 1, -1)):
        n = 2 ** lvl
        Sx = round_up(n + 1, 128)
        lz, ly = S // mz, S // my
        shape_l = (lz + 2 * GZ3, ly + 2 * GY3, Sx)
        shape_lc = (lz // 2 + 2 * GZ3, ly // 2 + 2 * GY3,
                    round_up(n // 2 + 1, 128))
        ok = (num_sharded == i and S % mz == 0 and S % my == 0
              and lz % 2 == 0 and ly % 16 == 0
              and min(lz, ly) >= replicate_below and S >= n + 1
              and (S // 2) % mz == 0 and (S // 2) % my == 0
              and takes(shape_l, shape_lc, steps))
        if ok:
            sizes.append((n, S, Sx))
            num_sharded += 1
            S //= 2
        elif num_sharded == i:
            S = max(S, n + 1)
            sizes.append((n, S, Sx))
        else:
            sizes.append((n, n + 1, round_up(n + 1, 128)))
    return PallasLevels3(tuple(sizes), min(num_sharded, len(sizes) - 1))


def pallas_level_sizes3(config: MultigridConfig,
                        mesh_shape: Tuple[int, int], *,
                        replicate_below: int = 32) -> PallasLevels3:
    """(n, S, Sx) per level: the sharded levels are those whose extended
    blocks K1_3-ext / K2_3-local take (``steps + 2`` window steps, as JAX
    gates them) and JAX's K1_3 tiles on its chip."""
    def takes(shape_l, shape_lc, steps):
        return (KT3.supported_local3(shape_l, shape_lc, steps + 2,
                                     config.dtype, ghost=GHOST3)
                and _tpu_tiling_exists(shape_l, steps + 4, WINDOW_BYTES))
    return _level_sizes3(config, mesh_shape, replicate_below, takes)


def pallas_var_level_sizes3(config: MultigridConfig,
                            mesh_shape: Tuple[int, int], *,
                            nplanes: int = 3,
                            replicate_below: int = 32) -> PallasLevels3:
    """:func:`pallas_level_sizes3` under the var kernels' gate and JAX's
    smaller var windows (``nplanes`` coefficient planes)."""
    def takes(shape_l, shape_lc, steps):
        return (KV3.supported_local_var3(shape_l, shape_lc, steps + 2,
                                         config.dtype, ghost=GHOST3,
                                         nplanes=nplanes)
                and _tpu_tiling_exists(shape_l, steps + 4,
                                       _var_budget(nplanes)))
    return _level_sizes3(config, mesh_shape, replicate_below, takes)


def build_pallas_poisson3(config: MultigridConfig, mesh_shape, *,
                          replicate_below: int = 32, device=None):
    """(levels, hierarchy) of the fused 3D tier on an ``mesh_shape`` grid
    of ranks; the coarse inverse lives on ``device``."""
    levels = pallas_level_sizes3(config, tuple(mesh_shape),
                                 replicate_below=replicate_below)
    hops = tuple(ConstStencilOp3D(n, S, Sx) for (n, S, Sx) in levels.sizes)
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = coarse_dense_inverse(hops[-1], device=device)
    return levels, Hierarchy(hops, coarse_inv)


# ---------------------------------------------------------------------------
# The fused distributed cycle
# ---------------------------------------------------------------------------

def _k1(u, b, cf, origin, n, shape_lc, cfg):
    sm, om = _sm(cfg, cfg.nu1)
    if cf is not None:
        return KV3.var_smooth_restrict_ext3(u, b, cf, origin, n, shape_lc,
                                            cfg.nu1, sm, om, ghost=GHOST3)
    return KT3.smooth_restrict_ext3(u, b, origin, n, shape_lc, cfg.nu1, sm,
                                    om, ghost=GHOST3)


def _k2(u, b, ec, cf, origin, n, cfg, want_norm):
    sm, om = _sm(cfg, cfg.nu2)
    if cf is not None:
        return KV3.var_prolong_smooth_ext3(u, b, ec, cf, origin, n, cfg.nu2,
                                           sm, om, ghost=GHOST3,
                                           want_resnorm=want_norm)
    return KT3.prolong_smooth_ext3(u, b, ec, origin, n, cfg.nu2, sm, om,
                                   ghost=GHOST3, want_resnorm=want_norm)


def _vcycle_pallas3(mesh: GridMesh, levels: PallasLevels3, hier: Hierarchy,
                    cfg: MultigridConfig, k: int, u, b,
                    want_norm: bool = False, halo: str = "lean",
                    u_ghosts_fresh: bool = False, coefs: Tuple = ()):
    """V/W/F-cycle at sharded level k on extended blocks.

    ``b``'s ghosts must be valid on entry.  Returns u' (owned region valid,
    ghosts stale), and with ``want_norm`` also the global post-cycle
    residual norm.  ``u_ghosts_fresh``: the caller guarantees ``u``'s ghosts
    hold what a refresh would deliver (the zero guess of a coarse visit), so
    the pre-K1 exchange is skipped.  ``coefs``: each sharded level's
    ghost-inclusive (C, Rz, Ry, Sx) coefficient block, or None for the
    constant-stencil kernels."""
    mz, my = mesh.shape
    n, S, _ = levels.sizes[k]
    lz, ly = S // mz, S // my
    origin = _ext_origin3(mesh, lz, ly)
    shape_lc = (lz // 2 + 2 * GZ3, ly // 2 + 2 * GY3,
                round_up(n // 2 + 1, 128))
    lean, dz, dy = _halo_depths3(cfg, halo)
    cf = coefs[k] if k < len(coefs) else None

    if not u_ghosts_fresh:
        u = refresh_ghosts3(mesh, u, n, lz, ly, dz, dy)
    u, rc = _k1(u, b, cf, origin, n, shape_lc, cfg)

    recurse_cnt = 2 if cfg.cycle in ("W", "F") else 1
    if k + 1 < levels.num_sharded:
        rc = refresh_ghosts3(mesh, rc, n // 2, lz // 2, ly // 2, dz, dy)
        ec = torch.zeros_like(rc)
        for i in range(recurse_cnt):
            sub = cfg if (cfg.cycle != "F" or i == 0) else \
                dataclasses.replace(cfg, cycle="V")
            ec = _vcycle_pallas3(mesh, levels, hier, sub, k + 1, ec, rc,
                                 halo=halo, u_ghosts_fresh=(i == 0),
                                 coefs=coefs)
    else:
        rc_full = gather_owned3(mesh, rc)
        ec_full = torch.zeros_like(rc_full)
        for i in range(recurse_cnt):
            sub = cfg if (cfg.cycle != "F" or i == 0) else \
                dataclasses.replace(cfg, cycle="V")
            if k + 1 == len(levels.sizes) - 1:
                ec_full = _coarsest_solve(hier, sub, ec_full, rc_full)
            else:
                ec_full = _replicated_cycle(hier, sub, k + 1, ec_full,
                                            rc_full)
        ec = scatter_owned3(mesh, ec_full, lz // 2, ly // 2, dtype=u.dtype)

    # K2 reads only the inner (GZ3/2, GY3/2) coarse ghost layers.
    ec = refresh_ghosts3(mesh, ec, n // 2, lz // 2, ly // 2,
                         GZ3 // 2 if lean else GZ3,
                         GY3 // 2 if lean else GY3)
    if not lean:
        u = refresh_ghosts3(mesh, u, n, lz, ly)
    if want_norm:
        u, ss = _k2(u, b, ec, cf, origin, n, cfg, True)
        ss = all_reduce_sum(mesh, ss)
        return u, torch.sqrt(ss).to(torch.float32)
    return _k2(u, b, ec, cf, origin, n, cfg, False)


def rhs_ext3(mesh: GridMesh, n0: int, lz: int, ly: int, Sx: int,
             forcing: float):
    """This rank's extended right-hand side block: the constant ``forcing *
    h^2`` (float32) on the owned interior nodes, ghosts refreshed."""
    shape = (lz + 2 * GZ3, ly + 2 * GY3, Sx)
    oz, oy = _ext_origin3(mesh, lz, ly)
    dev = mesh.device
    live = masks3(shape, n0, dev, (oz, oy))[0]
    gz = torch.arange(shape[0], device=dev) + oz
    gy = torch.arange(shape[1], device=dev) + oy
    cz, cy = mesh.coords
    owned = (((gz >= cz * lz) & (gz < (cz + 1) * lz))[:, None, None]
             & ((gy >= cy * ly) & (gy < (cy + 1) * ly))[None, :, None])
    h2 = (1.0 / n0) ** 2
    vals = torch.full(shape, float(forcing) * h2, dtype=torch.float32,
                      device=dev)
    b_ext = torch.where(live & owned, vals, 0.0)
    return refresh_ghosts3(mesh, b_ext, n0, lz, ly)


def _no_shardable_level(mesh: GridMesh, levels, finest_level: int,
                        what: str = ""):
    return ValueError(
        f"no level satisfies the 3D {what}Pallas shard constraints for mesh "
        f"{mesh.shape} at finest_level={finest_level} (levels: "
        f"{levels.sizes})")


def _solve(mesh: GridMesh, config: MultigridConfig, levels, hier, coefs, *,
           forcing, tol, max_cycles, num_cycles, halo):
    """The until-tol / fixed-cycle driver of the three solvers."""
    mz, my = mesh.shape
    n0, S0, Sx0 = levels.sizes[0]
    lz, ly = S0 // mz, S0 // my
    b_ext = rhs_ext3(mesh, n0, lz, ly, Sx0, forcing)
    u = torch.zeros_like(b_ext)
    r0 = np.float32(norm2_local(mesh, owned_view3(b_ext)).item())
    target = np.float32(tol) * r0
    ncyc = num_cycles if num_cycles is not None else max_cycles
    hist = np.full((ncyc + 1,), np.nan, np.float32)
    hist[0] = r0
    i, rnorm, prev = 0, r0, np.float32(np.inf)
    while i < ncyc and (num_cycles is not None
                        or (rnorm > target
                            and rnorm < np.float32(0.9) * prev)):
        u, rnew = _vcycle_pallas3(mesh, levels, hier, config, 0, u, b_ext,
                                  want_norm=True, halo=halo, coefs=coefs)
        prev, rnorm = rnorm, np.float32(rnew.item())
        hist[i + 1] = rnorm
        i += 1
    return SolveResult(u=owned_view3(u), res_history=torch.from_numpy(hist),
                       iterations=i, converged=bool(rnorm <= target)), levels


def sharded_solve_pallas3(config: MultigridConfig, mesh: GridMesh, *,
                          forcing: float = 6.0, tol: float = 1e-5,
                          max_cycles: int = 100,
                          num_cycles: Optional[int] = None,
                          replicate_below: int = 32, halo: str = "lean"):
    """Distributed 3D Poisson solve on the fused tier; every rank of
    ``mesh`` (a (mz, my) grid, :func:`.mesh.make_grid_mesh3`) calls
    it.

    Returns ``(SolveResult, PallasLevels3)``; ``result.u`` is this rank's
    owned (lz, ly, Sx) block (:func:`.local_ops.gather_full` of it assembles
    the global (S0, S0, Sx) array), ``res_history`` a float32 CPU tensor,
    the same on every rank.  ``forcing``: a constant.  ``halo``: ``"lean"``
    or ``"full"`` (:func:`_halo_depths3`), bitwise the same iterates.  The
    JAX package's ``jit`` has no counterpart here."""
    levels, hier = build_pallas_poisson3(config, mesh.shape,
                                         replicate_below=replicate_below,
                                         device=mesh.device)
    if levels.num_sharded < 1:
        raise _no_shardable_level(mesh, levels, config.finest_level)
    return _solve(mesh, config, levels, hier, (), forcing=forcing, tol=tol,
                  max_cycles=max_cycles, num_cycles=num_cycles, halo=halo)


# ---------------------------------------------------------------------------
# The variable-coefficient tier: K1v_3-ext / K2v_3-local
# ---------------------------------------------------------------------------

def build_pallas_diffusion3(config: MultigridConfig, mesh_shape, coefficient,
                            *, shift=0.0, replicate_below: int = 32,
                            device=None):
    """The 7-point flux hierarchy of -div(a grad u) (+ shift u) at
    :func:`pallas_var_level_sizes3`'s sizes: ``problems.diffusion3d``'s
    2x2x2 cell-averaged re-discretization on the host, in numpy (the
    operators stay host arrays; the coarse inverse lives on ``device``)."""
    with_shift = callable(shift) or float(shift) != 0.0
    levels = pallas_var_level_sizes3(config, tuple(mesh_shape),
                                     nplanes=4 if with_shift else 3,
                                     replicate_below=replicate_below)
    np_dt = _np_dtype(config.dtype)
    cells = cell_coefficients3(2 ** config.finest_level, coefficient)
    hops = []
    for (n, S, Sx) in levels.sizes:
        op = diffusion_op3_host(cells.astype(np_dt), n, S, Sx)
        if with_shift:
            op = _with_shift3(op, shift, np_dt)
        hops.append(op)
        if n > 2 ** config.coarsest_level:
            cells = coarsen_cells3(cells)
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = coarse_dense_inverse(hops[-1], device=device)
    return levels, Hierarchy(tuple(hops), coarse_inv)


def build_pallas_convection3(config: MultigridConfig, mesh_shape, *, eps, bx,
                             by, bz, replicate_below: int = 32, device=None):
    """The upwind ``Directional7Op`` hierarchy of -eps lap(u) + b . grad(u)
    at :func:`pallas_var_level_sizes3`'s 6-plane sizes (host arrays; the
    coarse inverse on ``device``)."""
    levels = pallas_var_level_sizes3(config, tuple(mesh_shape), nplanes=6,
                                     replicate_below=replicate_below)
    np_dt = _np_dtype(config.dtype)
    hops = [convection_diffusion_op3(n, S, Sx, eps, bx, by, bz, dtype=np_dt)
            for (n, S, Sx) in levels.sizes]
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = coarse_dense_inverse(hops[-1], device=device)
    return levels, Hierarchy(tuple(hops), coarse_inv)


def _host_stack3(op) -> np.ndarray:
    """A host operator's (C, S, S, Sx) coefficient stack: its ``coef_stack``,
    or its planes stacked (constant-wind ``Directional7Op`` levels)."""
    st = getattr(op, "coef_stack", None)
    if st is not None:
        return np.asarray(st)
    planes = ([*op.cp, *op.cm] if hasattr(op, "cp")
              else [op.tz, op.ty, op.tx] + ([op.c2] if op.c2 is not None
                                            else []))
    return np.stack([np.asarray(p) for p in planes])


def ext_coef_block3(op, mesh_shape, coords) -> np.ndarray:
    """Rank ``coords``'s ghost-inclusive (C, lz + 2 GZ3, ly + 2 GY3, Sx)
    block of an operator's coefficient stack: the ghost shells hold the
    neighbours' true values, and zero past the grid's edges.

    The slice of the JAX package's ``_ext_coef_layout3`` global stack that
    its sharding hands this rank, cut here from the stack without building
    the padded global copy."""
    st = _host_stack3(op)
    C, S, _, Sx = st.shape
    mz, my = mesh_shape
    lz, ly = S // mz, S // my
    ez, ey = lz + 2 * GZ3, ly + 2 * GY3
    z0, y0 = coords[0] * lz - GZ3, coords[1] * ly - GY3
    out = np.zeros((C, ez, ey, Sx), st.dtype)
    zs, ze = max(z0, 0), min(z0 + ez, S)
    ys, ye = max(y0, 0), min(y0 + ey, S)
    out[:, zs - z0:ze - z0, ys - y0:ye - y0] = st[:, zs:ze, ys:ye]
    return out


def _split_pallas_var3(levels: PallasLevels3, hier: Hierarchy,
                       mesh: GridMesh):
    """(coefs, hier_repl): this rank's ghost-inclusive coefficient block of
    each sharded level on the mesh's device, and the hierarchy on the
    device with the sharded levels' operators replaced by array-free
    placeholders (the replicated tail keeps its true var operators and the
    coarse inverse)."""
    coefs, repl_ops = [], []
    for k, op in enumerate(hier.levels):
        if k < levels.num_sharded and isinstance(op, (VarStencilOp3D,
                                                      Directional7Op)):
            blk = ext_coef_block3(op, mesh.shape, mesh.coords)
            coefs.append(torch.from_numpy(blk).to(mesh.device))
            del blk
            repl_ops.append(ConstStencilOp3D(op.n, op.S, op.Sx))
        else:
            if k < levels.num_sharded:
                coefs.append(None)
            repl_ops.append(op.to(mesh.device) if hasattr(op, "to") else op)
    inv = hier.coarse_inv
    return tuple(coefs), Hierarchy(tuple(repl_ops), None if inv is None
                                   else inv.to(mesh.device))


def _sharded_solve_var3_from(config: MultigridConfig, mesh: GridMesh, levels,
                             hier, *, forcing, tol, max_cycles, num_cycles,
                             halo):
    if levels.num_sharded < 1:
        raise _no_shardable_level(mesh, levels, config.finest_level, "var ")
    coefs, hier_repl = _split_pallas_var3(levels, hier, mesh)
    return _solve(mesh, config, levels, hier_repl, coefs, forcing=forcing,
                  tol=tol, max_cycles=max_cycles, num_cycles=num_cycles,
                  halo=halo)


def sharded_solve_pallas_var3(config: MultigridConfig, mesh: GridMesh, *,
                              coefficient, forcing: float = 6.0, shift=0.0,
                              tol: float = 1e-5, max_cycles: int = 100,
                              num_cycles: Optional[int] = None,
                              replicate_below: int = 32, halo: str = "lean"):
    """Distributed 3D variable-coefficient diffusion -div(a grad u) (+ shift
    u) = forcing on the fused K1v_3-ext / K2v_3-local tier; the contract of
    :func:`sharded_solve_pallas3`.  Each sharded level's flux planes (4 with
    a shift) live as this rank's ghost-inclusive block, filled at set-up."""
    levels, hier = build_pallas_diffusion3(
        config, mesh.shape, coefficient, shift=shift,
        replicate_below=replicate_below, device=mesh.device)
    return _sharded_solve_var3_from(config, mesh, levels, hier,
                                    forcing=forcing, tol=tol,
                                    max_cycles=max_cycles,
                                    num_cycles=num_cycles, halo=halo)


def sharded_solve_pallas_conv3(config: MultigridConfig, mesh: GridMesh, *,
                               eps, bx, by, bz, forcing: float = 6.0,
                               tol: float = 1e-5, max_cycles: int = 100,
                               num_cycles: Optional[int] = None,
                               replicate_below: int = 32,
                               halo: str = "lean"):
    """Distributed 3D upwind convection-diffusion -eps lap(u) + b . grad(u)
    = forcing (variable or constant winds) on the fused directional
    K1v_3-ext / K2v_3-local tier (6 planes); the contract of
    :func:`sharded_solve_pallas_var3`."""
    levels, hier = build_pallas_convection3(
        config, mesh.shape, eps=eps, bx=bx, by=by, bz=bz,
        replicate_below=replicate_below, device=mesh.device)
    return _sharded_solve_var3_from(config, mesh, levels, hier,
                                    forcing=forcing, tol=tol,
                                    max_cycles=max_cycles,
                                    num_cycles=num_cycles, halo=halo)
