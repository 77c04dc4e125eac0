"""Plain torch operators for 3D (7-point) structured-grid multigrid.

The conventions of :mod:`.ops` lifted one dimension:

* Grids are (Sz, Sy, Sx) padded node arrays (a cubic int S means (S, S, S));
  physical nodes ``0..n`` per axis, the unknowns ``1..n-1``, everything else
  zero and re-masked after every operation.
* The operator is the h-independent 7-point stencil (diagonal 6,
  off-diagonals -1); the right-hand side carries ``f * h^2``, so every level
  shares one stencil.
* Transfers are trilinear prolongation ``P`` and ``R = P^T / 2``: in three
  dimensions ``P^T`` scales a constant by 8 while the stencil absorbs one
  factor 4 per coarsening, so the /2 keeps the restricted right-hand side
  carrying ``f * (2h)^2``.  The coarse operator is the re-discretized
  stencil, not the Galerkin product.

Each function computes what its namesake in ``tpu_multigrid.core.ops3d``
computes, term for term in the same order (neighbour sums z, y, x; the
restriction blurs and decimates z, then y, then x), so float64 results agree
with the JAX package to ~1e-12.  Decimation and interleaving are strided
slices.
"""

from __future__ import annotations

import torch

from .ops import _axis_interior


def _shape3(S) -> tuple:
    """Cubic int or (Sz, Sy, Sx) tuple -> 3-tuple."""
    return (S, S, S) if isinstance(S, int) else tuple(S)


def interior_mask3(S, n: int, device=None) -> torch.Tensor:
    """Boolean (Sz, Sy, Sx) mask of the unknowns: 1 <= i, j, k <= n-1."""
    sz, sy, sx = _shape3(S)
    mz = _axis_interior(sz, n, device)
    my = _axis_interior(sy, n, device)
    mx = _axis_interior(sx, n, device)
    return mz[:, None, None] & my[None, :, None] & mx[None, None, :]


def mask_interior3(u: torch.Tensor, n: int) -> torch.Tensor:
    return torch.where(interior_mask3(u.shape[-3:], n, u.device), u, 0.0)


def parity3(S, device=None) -> torch.Tensor:
    """(i + j + k) % 2 over a (Sz, Sy, Sx) grid."""
    sz, sy, sx = _shape3(S)
    i = torch.arange(sz, device=device)[:, None, None]
    j = torch.arange(sy, device=device)[None, :, None]
    k = torch.arange(sx, device=device)[None, None, :]
    return (i + j + k) % 2


# ---------------------------------------------------------------------------
# 7-point stencil primitives
# ---------------------------------------------------------------------------

def neighbor_sum3(u: torch.Tensor) -> torch.Tensor:
    """Sum of the six face neighbours via rolls, z, then y, then x (wrapped
    values land on masked nodes only)."""
    return (torch.roll(u, 1, -3) + torch.roll(u, -1, -3)
            + torch.roll(u, 1, -2) + torch.roll(u, -1, -2)
            + torch.roll(u, 1, -1) + torch.roll(u, -1, -1))


def apply_poisson3(u: torch.Tensor, n: int) -> torch.Tensor:
    return mask_interior3(6.0 * u - neighbor_sum3(u), n)


def residual3(u: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    return mask_interior3(b - 6.0 * u + neighbor_sum3(u), n)


def jacobi_sweeps3(u, b, n: int, omega, sweeps: int) -> torch.Tensor:
    """Weighted Jacobi, D = 6I: v <- (1-w) v + (w/6)(b + sum of neighbours),
    masked to the interior; ``omega`` a float or a per-sweep tuple."""
    if sweeps <= 0:
        return u
    m = interior_mask3(u.shape[-3:], n, u.device)
    sixth = 1.0 / 6.0
    ws = omega if isinstance(omega, tuple) else (omega,)
    v = u
    for s in range(sweeps):
        w = ws[s % len(ws)]
        vn = (1.0 - w) * v + (sixth * w) * (b + neighbor_sum3(v))
        v = torch.where(m, vn, 0.0)
    return v


def redblack_gs_sweeps3(u, b, n: int, sweeps: int) -> torch.Tensor:
    """Red-black Gauss-Seidel on the 3D checkerboard, (i+j+k) even first."""
    if sweeps <= 0:
        return u
    inter = interior_mask3(u.shape[-3:], n, u.device)
    parity = parity3(u.shape[-3:], u.device)
    colors = (inter & (parity == 0), inter & (parity == 1))
    v = u
    for _ in range(sweeps):
        for color in colors:
            v = torch.where(color, (1.0 / 6.0) * (b + neighbor_sum3(v)), v)
    return v


# ---------------------------------------------------------------------------
# Inter-grid transfers
# ---------------------------------------------------------------------------

def _crop_pad3(x: torch.Tensor, shape) -> torch.Tensor:
    """Crop or zero-pad x to ``shape``."""
    if tuple(x.shape) == tuple(shape):
        return x
    out = x.new_zeros(shape)
    sl = tuple(slice(0, min(a, b)) for a, b in zip(x.shape, shape))
    out[sl] = x[sl]
    return out


def _blur_decimate(t: torch.Tensor, ax: int) -> torch.Tensor:
    """[1/2, 1, 1/2] blur along ``ax``, then keep the even indices below
    2 * (size // 2).  The roll wraps only onto masked zeros."""
    t = t + 0.5 * (torch.roll(t, 1, ax) + torch.roll(t, -1, ax))
    m = t.shape[ax] // 2
    even = (slice(None),) * ax + (slice(None, None, 2),)
    return t.narrow(ax, 0, 2 * m)[even]


def restrict_fw3(rf: torch.Tensor, nf: int, Sc) -> torch.Tensor:
    """Full-weighting restriction R = P^T / 2, fine -> coarse padded grid:
    blur and decimate z, then y, then x, times 1/2, cropped or padded to
    ``Sc`` and masked to the coarse interior."""
    t = rf
    for ax in (0, 1, 2):
        t = _blur_decimate(t, ax)
    return mask_interior3(_crop_pad3(0.5 * t, _shape3(Sc)), nf // 2)


def _pad_end(v: torch.Tensor, ax: int) -> torch.Tensor:
    shape = list(v.shape)
    shape[ax] = 1
    return torch.cat([v, v.new_zeros(shape)], ax)


def prolong3(ec: torch.Tensor, nc: int, Sf) -> torch.Tensor:
    """Trilinear prolongation, coarse -> fine ``Sf``: the eight parity
    phases, each averaging the two coarse neighbours along its odd axes (z,
    then y, then x); coarse nodes past the fine array's reach read zero."""
    shf = _shape3(Sf)
    m = tuple(min(ec.shape[ax], (shf[ax] + 1) // 2) for ax in range(3))
    e = ec[:m[0], :m[1], :m[2]]
    f = ec.new_zeros(tuple(2 * x for x in m))
    for pz in (0, 1):
        for py in (0, 1):
            for px in (0, 1):
                v = e
                for ax, p in enumerate((pz, py, px)):
                    if p:
                        lo = v.narrow(ax, 0, v.shape[ax] - 1)
                        hi = v.narrow(ax, 1, v.shape[ax] - 1)
                        v = _pad_end(0.5 * (lo + hi), ax)
                f[pz::2, py::2, px::2] = v
    return mask_interior3(_crop_pad3(f, shf), 2 * nc)
