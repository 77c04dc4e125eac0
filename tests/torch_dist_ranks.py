"""Rank programs of tests/test_torch_dist.py, tests/test_torch_dist_fas.py
and tests/test_torch_dist3.py, run by ``dist.run_on_mesh``.

This module imports torch and tpu_multigrid_torch only: the spawned ranks
import it to find their program, and none of them pays for a JAX import.
Each program returns CPU tensors and plain values.
"""

import numpy as np
import torch

import tpu_multigrid_torch as tmg
from tpu_multigrid_torch import dist
from tpu_multigrid_torch.dist import pallas_cycle as PC
from tpu_multigrid_torch.dist import pallas_cycle3 as P3

# (dr, dc) depths of the ghost refresh under test: full, the lean (8, 128)
# of Jacobi (2, 2), and an uneven one.
DEPTHS = [(16, 256), (8, 128), (16, 128)]

# The until-tol solves: from zero to 1e-2, and from FMG to 0.3 (at level 9
# FMG's start lies within 10x of the float32 floor of this h^2-scaled
# right-hand side, ~2e-5 of the zero start's residual).
FMG_CASES = (("until_tol", {"tol": 1e-2}),
             ("fmg", {"tol": 0.3, "use_fmg": True}))


def seeded_blocks(mesh_shape, seed, lr, lc):
    """The global array of every rank's (lr, lc) extended block, seeded
    random values everywhere (ghosts included)."""
    my, mx = mesh_shape
    R, C = lr + 2 * PC.GR, lc + 2 * PC.GC
    return np.random.default_rng(seed).standard_normal(
        (my * R, mx * C)).astype(np.float32)


def refresh_program(mesh, seed, n, lr, lc):
    """This rank's block of :func:`seeded_blocks`, refreshed at each of
    :data:`DEPTHS`; the gathered owned regions of the full refresh; and
    this rank's scatter of the array's leading (my lr, mx lc) part."""
    glob = seeded_blocks(mesh.shape, seed, lr, lc)
    R, C = lr + 2 * PC.GR, lc + 2 * PC.GC
    cy, cx = mesh.coords
    blk = torch.from_numpy(glob[cy * R:(cy + 1) * R, cx * C:(cx + 1) * C])
    out = {}
    for dr, dc in DEPTHS:
        out[(dr, dc)] = PC.refresh_ghosts(mesh, blk.clone(), n, lr, lc, dr,
                                          dc)
    out["gather"] = PC.gather_owned(mesh, out[DEPTHS[0]])
    S = mesh.shape[0] * lr
    full = torch.from_numpy(glob[:S, :mesh.shape[1] * lc].copy())
    out["scatter"] = PC.scatter_owned(mesh, full, lr, lc)
    out["coords"] = mesh.coords
    return out


def _gathered(mesh, block):
    return dist.gather_full(mesh, block.contiguous())


def solve_program(mesh, level):
    """The level-``level`` solves of the cross-rank tests on ``mesh``."""
    cfg = tmg.MultigridConfig(finest_level=level, coarsest_level=3)
    out = {}
    res, lv = dist.refined_sharded_solve_pallas(
        cfg, mesh, num_cycles=2, ts=True, ds_levels=2, replicate_below=128)
    out["refined"] = (res.res_history, _gathered(mesh, res.u), lv.sizes,
                      lv.num_sharded)
    door = dict(config=cfg, mesh=mesh, dist_path="pallas", refined=False)
    res = tmg.solve_poisson(level, num_cycles=4, **door)
    out["fixed"] = (res.res_history, _gathered(mesh, res.u))
    for key, kw in FMG_CASES:
        res = tmg.solve_poisson(level, max_cycles=30, **door, **kw)
        out[key] = (res.iterations, res.converged, res.res_history)
    runs = [dist.sharded_solve_pallas(cfg, mesh, num_cycles=3, tol=0.0,
                                      replicate_below=64, halo=halo)[0]
            for halo in ("lean", "full")]
    out["halo"] = [(r.res_history, r.u.clone()) for r in runs]
    return out




# The FAS program of tests/test_torch_dist_fas.py: Bratu (lam = 4) at
# FAS_LEVEL, coarsest level 4, 1 and FAS_CYCLES fixed cycles.
FAS_LEVEL, FAS_CYCLES, FAS_LAM = 9, 3, 4.0


def fas_program(mesh):
    """The fused FAS tier's Bratu solves on ``mesh``, {cycles: (history,
    gathered iterate)}, and the level layout."""
    cfg = tmg.MultigridConfig(finest_level=FAS_LEVEL, coarsest_level=4)
    phi = tmg.BratuNonlinearity(FAS_LAM)
    out = {}
    for cycles in (1, FAS_CYCLES):
        res, lv = dist.fas_sharded_solve_pallas(cfg, mesh, phi=phi, dphi=phi,
                                                num_cycles=cycles, tol=None)
        out[cycles] = (res.res_history, _gathered(mesh, res.u))
    return out, lv.sizes, lv.num_sharded


# The 3D tier's programs (tests/test_torch_dist3.py).  (dz, dy) depths of
# the 3D ghost refresh: full, the lean (6, 8) of Chebyshev (3, 2), and an
# uneven one.
DEPTHS3 = [(16, 16), (6, 8), (16, 8)]
# Level-6 solves: Chebyshev (3, 2), coarsest level 3, replicate below 16.
DIST3_LEVEL, DIST3_CYCLES = 6, 2


def dist3_config():
    return tmg.MultigridConfig(finest_level=DIST3_LEVEL, coarsest_level=3,
                               smoother="chebyshev", nu1=3, nu2=2)


def dist3_coefficient(x, y, z):
    """The var solves' coefficient: a jump of 10 in one octant."""
    return 1.0 + 10.0 * ((x > 0.5) & (z > 0.5))


def seeded_blocks3(mesh_shape, seed, lz, ly, Sx):
    """The global array of every rank's (lz, ly, Sx) extended 3D block,
    seeded random values everywhere (ghosts included)."""
    mz, my = mesh_shape
    Rz, Ry = lz + 2 * P3.GZ3, ly + 2 * P3.GY3
    return np.random.default_rng(seed).standard_normal(
        (mz * Rz, my * Ry, Sx)).astype(np.float32)


def refresh3_program(mesh, seed, n, lz, ly, Sx):
    """This rank's block of :func:`seeded_blocks3`, refreshed at each of
    :data:`DEPTHS3`; the gathered owned regions of the full refresh; and
    this rank's scatter of the array's leading (mz lz, my ly) part."""
    glob = seeded_blocks3(mesh.shape, seed, lz, ly, Sx)
    Rz, Ry = lz + 2 * P3.GZ3, ly + 2 * P3.GY3
    cz, cy = mesh.coords
    blk = torch.from_numpy(glob[cz * Rz:(cz + 1) * Rz,
                                cy * Ry:(cy + 1) * Ry])
    out = {}
    for dz, dy in DEPTHS3:
        out[(dz, dy)] = P3.refresh_ghosts3(mesh, blk.clone(), n, lz, ly, dz,
                                           dy)
    out["gather"] = P3.gather_owned3(mesh, out[DEPTHS3[0]])
    full = torch.from_numpy(glob[:mesh.shape[0] * lz,
                                 :mesh.shape[1] * ly].copy())
    out["scatter"] = P3.scatter_owned3(mesh, full, lz, ly)
    out["coords"] = mesh.coords
    return out


def dist3_program(mesh, refresh_args):
    """The cross-mesh checks of the 3D tier on ``mesh``: the refresh of
    :func:`refresh3_program`, and the level-6 Poisson and var solves
    (gathered, lean and full halo) with their level layouts."""
    out = {"refresh": refresh3_program(mesh, *refresh_args)}
    cfg = dist3_config()
    kw = dict(num_cycles=DIST3_CYCLES, tol=0.0, replicate_below=16)
    for name, solver, extra in (
            ("poisson", dist.sharded_solve_pallas3, {}),
            ("var", dist.sharded_solve_pallas_var3,
             dict(coefficient=dist3_coefficient))):
        for halo in ("lean", "full"):
            res, lv = solver(cfg, mesh, halo=halo, **kw, **extra)
            out[(name, halo)] = (res.res_history,
                                 _gathered(mesh, res.u), lv)
    return out
