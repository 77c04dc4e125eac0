"""Rank-local stencil and transfer operators with one-ring halo exchanges.

Each (S, S) grid is decomposed (gy, gx) over a :class:`.mesh.GridMesh`;
every operator here runs on this rank's (r, c) block and pulls one ghost
ring from its neighbours through the mesh's transport.  Ghosts that wrap
around the grid (rank 0 receiving from the last rank) land only on
boundary or padding nodes, which the interior masks zero.

The part of ``tpu_multigrid/dist/local_ops.py`` that the fused tier
(:mod:`.pallas_cycle`) reads: the one-ring halo, the interior mask, the
residual, full-weighting restriction, bilinear prolongation, the global
norm and the gather, each in the JAX package's order of operations.
"""

from __future__ import annotations

import torch

from .mesh import (GridMesh, all_gather_rows_cols, all_reduce_sum,
                   shift_from_next, shift_from_prev)

GY, GX = 0, 1


def with_halo1(mesh: GridMesh, u):
    """Local (r, c) block -> (r + 2, c + 2) with a one-deep ghost ring.

    Rows first, then the columns of the row-extended block, so corner
    ghosts arrive in two hops (no diagonal sends)."""
    top = shift_from_prev(mesh, u[-1:, :], GY)
    bot = shift_from_next(mesh, u[:1, :], GY)
    xr = torch.cat([top, u, bot], dim=0)
    lf = shift_from_prev(mesh, xr[:, -1:], GX)
    rt = shift_from_next(mesh, xr[:, :1], GX)
    return torch.cat([lf, xr, rt], dim=1)


def local_offsets(mesh: GridMesh, shape):
    """Global coordinates of the (r, c) block's cell (0, 0)."""
    r, c = shape
    return mesh.coords[0] * r, mesh.coords[1] * c


def interior_mask_local(mesh: GridMesh, shape, n: int, device=None):
    r, c = shape
    r0, c0 = local_offsets(mesh, shape)
    gi = torch.arange(r, device=device) + r0
    gj = torch.arange(c, device=device) + c0
    return (((gi >= 1) & (gi <= n - 1))[:, None]
            & ((gj >= 1) & (gj <= n - 1))[None, :])


def neighbor_sum_local(mesh: GridMesh, u):
    h = with_halo1(mesh, u)
    return ((h[:-2, 1:-1] + h[2:, 1:-1]) + h[1:-1, :-2]) + h[1:-1, 2:]


def residual_local(mesh: GridMesh, u, b, n: int):
    r = (b - 4.0 * u) + neighbor_sum_local(mesh, u)
    return torch.where(interior_mask_local(mesh, u.shape, n, u.device), r,
                       0.0)


def restrict_fw_local(mesh: GridMesh, rf, nf: int):
    """Full-weighting restriction of a local fine block to the local coarse
    block (r/2, c/2) at (r0/2, c0/2) (block sides are even)."""
    nc = nf // 2
    h = with_halo1(mesh, rf)
    row3 = (h[:-2, 1:-1] + 2.0 * h[1:-1, 1:-1]) + h[2:, 1:-1]
    hh = torch.cat([shift_from_prev(mesh, row3[:, -1:], GX), row3,
                    shift_from_next(mesh, row3[:, :1], GX)], dim=1)
    g = 0.25 * ((hh[:, :-2] + 2.0 * hh[:, 1:-1]) + hh[:, 2:])
    coarse = g[::2, ::2]
    m = interior_mask_local(mesh, coarse.shape, nc, rf.device)
    return torch.where(m, coarse, 0.0)


def prolong_local(mesh: GridMesh, ec, nc: int):
    """Bilinear prolongation of a local coarse block to the local fine
    block."""
    nf = 2 * nc
    h = with_halo1(mesh, ec)
    c, cdn = h[1:-1, 1:-1], h[2:, 1:-1]
    crt, cdr = h[1:-1, 2:], h[2:, 2:]
    r, cc = c.shape
    f = ec.new_empty((2 * r, 2 * cc))
    f[0::2, 0::2] = c
    f[1::2, 0::2] = 0.5 * (c + cdn)
    f[0::2, 1::2] = 0.5 * (c + crt)
    f[1::2, 1::2] = 0.25 * (((c + cdn) + crt) + cdr)
    m = interior_mask_local(mesh, f.shape, nf, ec.device)
    return torch.where(m, f, 0.0)


def norm2_local(mesh: GridMesh, r):
    """Global L2 norm of a decomposed array: the ranks' sums of squares,
    added over the mesh (0-d float32)."""
    ss = all_reduce_sum(mesh, torch.sum(r * r))
    return torch.sqrt(ss).to(torch.float32)


def gather_full(mesh: GridMesh, x):
    """Every rank's block assembled into the full global array, on every
    rank."""
    return all_gather_rows_cols(mesh, x)
