"""Plain torch operators for structured-grid 2D multigrid.

Every level is a dense ``(S, S)`` node grid: the physical grid occupies
indices ``0..n`` (``n = 2**level`` cells), the unknowns are the interior
``1..n-1`` in each axis, and the homogeneous-Dirichlet boundary plus any
alignment padding is held at zero.  The operator is the FEM-scaled 5-point
stencil ``[[0,-1,0],[-1,4,-1],[0,-1,0]]`` (the right-hand side carries
``f*h^2``).

Each function computes what its namesake in ``tpu_multigrid.core.ops``
computes, term for term in the same order, so float32 results agree with
the JAX package to rounding and float64 results to ~1e-15.  Neighbour
access uses ``torch.roll``: wrapped values only land on non-interior
rows/cols, which the interior mask zeroes.

Transfers are the variational pair for nested P1 elements: bilinear
prolongation ``P`` and its exact adjoint ``R = P^T``, the full-weighting
stencil ``[[1,2,1],[2,4,2],[1,2,1]]/4`` in FEM scaling.
"""

from __future__ import annotations

import math

import torch


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------

def _axis_interior(S: int, n: int, device) -> torch.Tensor:
    i = torch.arange(S, device=device)
    return (i >= 1) & (i <= n - 1)


def interior_mask(S: int, n: int, device=None) -> torch.Tensor:
    """Boolean (S, S) mask of interior (unknown) nodes: 1 <= i,j <= n-1."""
    m = _axis_interior(S, n, device)
    return m[:, None] & m[None, :]


def mask_interior(u: torch.Tensor, n: int) -> torch.Tensor:
    """Zero out everything but the interior."""
    return torch.where(interior_mask(u.shape[-1], n, u.device), u, 0.0)


# ---------------------------------------------------------------------------
# 5-point stencil primitives
# ---------------------------------------------------------------------------

def neighbor_sum(u: torch.Tensor) -> torch.Tensor:
    """u[i-1,j] + u[i+1,j] + u[i,j-1] + u[i,j+1] via rolls."""
    return (torch.roll(u, 1, -2) + torch.roll(u, -1, -2)
            + torch.roll(u, 1, -1) + torch.roll(u, -1, -1))


def apply_poisson(u: torch.Tensor, n: int) -> torch.Tensor:
    """A u with the FEM-scaled 5-point stencil (diagonal 4), interior only."""
    return mask_interior(4.0 * u - neighbor_sum(u), n)


def residual(u: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """r = b - A u on the interior."""
    return mask_interior(b - 4.0 * u + neighbor_sum(u), n)


def chebyshev_omegas(k: int, lo: float = 0.4, hi: float = 2.0) -> tuple:
    """Per-step Jacobi weights for degree-``k`` Chebyshev smoothing.

    The reciprocals of the Chebyshev roots on the ``D^-1 A`` interval
    ``[lo, hi]``, in descending order: the over-relaxed steps come first so
    that later steps damp their rounding noise, and the last step is the
    most damping one.
    """
    roots = [(lo + hi) / 2 + (hi - lo) / 2 * math.cos(
        math.pi * (2 * j + 1) / (2 * k)) for j in range(k)]
    return tuple(sorted((1.0 / t for t in roots), reverse=True))


def jacobi_sweeps(u: torch.Tensor, b: torch.Tensor, n: int, omega,
                  sweeps: int) -> torch.Tensor:
    """`sweeps` sweeps of weighted Jacobi, fixed D = 4I:
    v <- (1-w) v + (w/4)(b + sum of neighbours), masked to the interior.

    ``omega`` may be a float (stationary) or a tuple of per-sweep weights
    (Chebyshev schedule, :func:`chebyshev_omegas`), cycled when shorter
    than ``sweeps``.
    """
    if sweeps <= 0:
        return u
    m = interior_mask(u.shape[-1], n, u.device)
    ws = omega if isinstance(omega, tuple) else (omega,)
    v = u
    for s in range(sweeps):
        w = ws[s % len(ws)]
        v = torch.where(m, (1.0 - w) * v + (0.25 * w) * (b + neighbor_sum(v)),
                        0.0)
    return v


def _parity_masks(S: int, n: int, device):
    i = torch.arange(S, device=device)
    inter = interior_mask(S, n, device)
    parity = (i[:, None] + i[None, :]) % 2
    return inter & (parity == 0), inter & (parity == 1)


def redblack_gs_sweeps(u: torch.Tensor, b: torch.Tensor, n: int,
                       sweeps: int) -> torch.Tensor:
    """Red-black Gauss-Seidel: two masked half-sweeps per sweep, red
    (``(i+j) % 2 == 0``) first."""
    if sweeps <= 0:
        return u
    red, black = _parity_masks(u.shape[-1], n, u.device)
    v = u
    for _ in range(sweeps):
        for color in (red, black):
            v = torch.where(color, 0.25 * (b + neighbor_sum(v)), v)
    return v


# ---------------------------------------------------------------------------
# Inter-grid transfers
# ---------------------------------------------------------------------------

def _blur121(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Zero-boundary [1/2, 1, 1/2] window along one trailing axis:
    x[i] + 0.5 * (x[i-1] + x[i+1]), out-of-range taps reading 0."""
    lo = torch.zeros_like(x)
    hi = torch.zeros_like(x)
    if axis == -1:
        lo[..., 1:] = x[..., :-1]
        hi[..., :-1] = x[..., 1:]
    else:
        lo[..., 1:, :] = x[..., :-1, :]
        hi[..., :-1, :] = x[..., 1:, :]
    return x + 0.5 * (lo + hi)


def _crop_pad_square(x: torch.Tensor, S: int) -> torch.Tensor:
    """Crop or zero-pad the trailing two axes to (S, S)."""
    side = x.shape[-1]
    if side >= S:
        return x[..., :S, :S]
    out = x.new_zeros(x.shape[:-2] + (S, S))
    out[..., :side, :side] = x
    return out


def restrict_fw(rf: torch.Tensor, nf: int, Sc: int) -> torch.Tensor:
    """Full-weighting restriction, FEM scaling R = P^T (stencil /4).

    Fine grid ``(Sf, Sf)`` with ``nf`` cells -> coarse ``(Sc, Sc)`` with
    ``nf//2`` cells: the separable [1/2, 1, 1/2] blur along columns, then
    rows, sampled at the even fine nodes and masked to the coarse interior.
    """
    t = _blur121(_blur121(rf, -1), -2)
    coarse = _crop_pad_square(t[..., ::2, ::2], Sc)
    return mask_interior(coarse, nf // 2)


def prolong(ec: torch.Tensor, nc: int, Sf: int) -> torch.Tensor:
    """Bilinear prolongation, coarse ``(Sc, Sc)`` -> fine ``(Sf, Sf)``.

    fine[2i,2j] = c[i,j]; odd rows/cols average 2 neighbours; odd-odd
    averages 4.  Coarse rows/cols past the fine array's reach read as zero.
    """
    return _prolong_phases(ec, nc, Sf, diag="bilinear")


def _prolong_phases(ec: torch.Tensor, nc: int, Sf: int, *,
                    diag: str) -> torch.Tensor:
    """The bilinear / P1 prolongation: the four parity phases of the fine
    grid from the coarse one.  ``diag`` sets the odd-odd phase: "bilinear"
    averages the 4 coarse corners, "p1" the 2 ends of the NE-SW diagonal
    edge (criss-cross triangulation)."""
    m = min(ec.shape[-1], (Sf + 1) // 2)
    e = ec[..., :m, :m]
    f = ec.new_zeros(ec.shape[:-2] + (2 * m, 2 * m))
    f[..., 0::2, 0::2] = e
    f[..., 1:-1:2, 0::2] = 0.5 * (e[..., :-1, :] + e[..., 1:, :])
    f[..., 0::2, 1:-1:2] = 0.5 * (e[..., :, :-1] + e[..., :, 1:])
    if diag == "bilinear":
        f[..., 1:-1:2, 1:-1:2] = 0.25 * (e[..., :-1, :-1] + e[..., :-1, 1:]
                                         + e[..., 1:, :-1] + e[..., 1:, 1:])
    else:
        f[..., 1:-1:2, 1:-1:2] = 0.5 * (e[..., 1:, :-1] + e[..., :-1, 1:])
    return mask_interior(_crop_pad_square(f, Sf), 2 * nc)


def restrict_injection(rf: torch.Tensor, nf: int, Sc: int) -> torch.Tensor:
    """Injection restriction: each coarse node takes the coinciding fine
    value, times 4 to keep the FEM (h-independent) scaling, masked to the
    coarse interior."""
    coarse = 4.0 * rf[..., ::2, ::2]
    return mask_interior(_crop_pad_square(coarse, Sc), nf // 2)


def prolong_p1(ec: torch.Tensor, nc: int, Sf: int) -> torch.Tensor:
    """P1 (triangular-element) prolongation: as :func:`prolong`, except that
    the odd-odd nodes lie on the NE-SW diagonal edge and average its two
    ends, c[i+1, j] and c[i, j+1]."""
    return _prolong_phases(ec, nc, Sf, diag="p1")


def norm2(r: torch.Tensor) -> torch.Tensor:
    """Global L2 norm of a residual grid as a 0-d float32 tensor (the
    history dtype).  Accumulates in the input precision (>= f32)."""
    racc = r.float() if r.dtype == torch.bfloat16 else r
    return torch.sqrt(torch.sum(racc * racc)).to(torch.float32)
