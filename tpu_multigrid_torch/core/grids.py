"""Grid hierarchy construction.

On a structured grid the operator is a stencil, so "assembly" is closed
form: a hierarchy is a tuple of level operators, finest first, plus the
dense inverse of the coarsest level's interior operator.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import MultigridConfig
from .operators import (ConstStencilOp, ConstStencilOp3D, VarStencilOp,
                        galerkin_coarsen, galerkin_coarsen_host, poisson_op)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def level_sizes(config: MultigridConfig, *, align: int = 1,
                min_pad_level: int = 99) -> Tuple[Tuple[int, int], ...]:
    """(n, S) per level, finest first.

    ``S`` is the padded array side: ``n + 1`` rounded up to ``align`` for
    levels >= ``min_pad_level``.  The transfer operators crop/pad so only
    the physical ``0..n`` region couples across levels.
    """
    sizes = []
    for lvl in range(config.finest_level, config.coarsest_level - 1, -1):
        n = 2 ** lvl
        S = n + 1
        if lvl >= min_pad_level and align > 1:
            S = round_up(S, align)
        sizes.append((n, S))
    return tuple(sizes)


class Hierarchy:
    """Level stack: operators finest->coarsest + the coarse dense inverse
    (``None`` when the coarsest level is smoothed instead)."""

    def __init__(self, levels, coarse_inv: Optional[torch.Tensor]):
        self.levels = tuple(levels)
        self.coarse_inv = coarse_inv

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def to(self, device) -> "Hierarchy":
        """The hierarchy with every level's arrays and the coarse inverse as
        tensors on ``device`` (levels without arrays are shared)."""
        levels = tuple(op.to(device) if hasattr(op, "to") else op
                       for op in self.levels)
        inv = None if self.coarse_inv is None else self.coarse_inv.to(device)
        return Hierarchy(levels, inv)

    def __repr__(self):
        return f"Hierarchy({list(self.levels)!r})"


def dense_poisson_matrix(n: int, ndim: int = 2) -> np.ndarray:
    """Dense (m, m) interior matrix of the h-independent 2·ndim+1-point
    stencil (diag 2·ndim, off −1), m = (n−1)^ndim, row-major interior
    ordering."""
    m1 = n - 1
    m = m1 ** ndim
    idx = np.arange(m).reshape((m1,) * ndim)
    a = np.zeros((m, m))
    a[np.arange(m), np.arange(m)] = 2.0 * ndim
    for ax in range(ndim):
        lo = [slice(None)] * ndim
        hi = [slice(None)] * ndim
        lo[ax] = slice(0, -1)
        hi[ax] = slice(1, None)
        rows = idx[tuple(lo)].ravel()
        cols = idx[tuple(hi)].ravel()
        a[rows, cols] -= 1.0
        a[cols, rows] -= 1.0
    return a


def coarse_dense_inverse(op, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """Dense inverse of the interior operator, computed once in float64
    numpy and stored in ``dtype`` (float32 unless asked, for every solve
    dtype, as the JAX package stores it).  The constant 5- and 7-point
    stencils are assembled in closed form; a :class:`VarStencilOp` from its
    coefficient planes (numpy, or tensors copied to the host); any other
    operator (the 19-point ``Const19Op``, the 3D ``VarStencilOp3D`` and
    ``Directional7Op``) is probed with unit grids through its ``apply`` in
    float32 on the host, as the JAX package probes them."""
    if type(op) in (ConstStencilOp, ConstStencilOp3D):
        a = dense_poisson_matrix(op.n, getattr(op, "ndim", 2))
        return torch.as_tensor(np.linalg.inv(a), dtype=dtype, device=device)
    if not isinstance(op, VarStencilOp):
        return _probed_inverse(op, dtype, device)
    coef = op.coef
    if isinstance(coef, torch.Tensor):
        coef = coef.cpu().numpy()
    n = op.n
    ri = rj = n - 1
    m = ri * rj
    a = np.zeros((m, m))
    idx = np.arange(m).reshape(ri, rj)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            C = coef[di + 1, dj + 1, 1:n, 1:n].astype(np.float64)
            i0, i1 = max(0, -di), ri - max(0, di)
            j0, j1 = max(0, -dj), rj - max(0, dj)
            rows = idx[i0:i1, j0:j1].ravel()
            cols = idx[i0 + di:i1 + di, j0 + dj:j1 + dj].ravel()
            a[rows, cols] += C[i0:i1, j0:j1].ravel()
    inv = np.linalg.inv(a)
    return torch.as_tensor(inv, dtype=dtype, device=device)


def _probed_inverse(op, dtype, device) -> torch.Tensor:
    """The inverse of an operator known only through ``apply``: unit grids
    on the unknowns, applied as one float32 batch; column k of the matrix is
    ``apply(e_k)``.  An operator holding arrays is copied to the host
    first."""
    if hasattr(op, "to"):
        op = op.to("cpu")
    inter = _unknown_slices(op)
    shp = tuple(s.stop - s.start for s in inter)
    m = int(np.prod(shp))
    grids = torch.zeros((m,) + tuple(op.grid_shape), dtype=torch.float32)
    grids[(slice(None),) + inter] = torch.eye(m).reshape((m,) + shp)
    cols = op.apply(grids)[(slice(None),) + inter].reshape(m, m)
    a = cols.double().numpy().T
    return torch.as_tensor(np.linalg.inv(a), dtype=dtype, device=device)


def _unknown_slices(op) -> tuple:
    """Per-axis slices of the operator's unknowns: the Dirichlet interior
    ``1..n-1`` along each of its ``ndim`` axes."""
    return (slice(1, op.n),) * getattr(op, "ndim", 2)


def coarse_solve(op, coarse_inv: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Direct coarsest-grid solve via the precomputed dense inverse."""
    inter = _unknown_slices(op)
    shp = tuple(s.stop - s.start for s in inter)
    rhs = b[inter].reshape(-1).to(coarse_inv.dtype)
    sol = torch.mv(coarse_inv, rhs).reshape(shp).to(b.dtype)
    out = b.new_zeros(getattr(op, "grid_shape", (op.S, op.S)))
    out[inter] = sol
    return out


def build_poisson_hierarchy(config: MultigridConfig, *, align: int = 1,
                            min_pad_level: int = 99,
                            device=None) -> Hierarchy:
    """Constant-coefficient Poisson hierarchy (re-discretized every level;
    for nested P1 elements this equals the Galerkin operator R A P)."""
    sizes = level_sizes(config, align=align, min_pad_level=min_pad_level)
    levels = tuple(poisson_op(n, S) for n, S in sizes)
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = coarse_dense_inverse(levels[-1], device=device)
    return Hierarchy(levels, coarse_inv)


def build_galerkin_hierarchy(fine_op: VarStencilOp, config: MultigridConfig,
                             *, align: int = 1, min_pad_level: int = 99,
                             method: str = "host") -> Hierarchy:
    """Variable-coefficient hierarchy: coarse operators R A P, built at
    set-up.  ``method="host"`` evaluates the closed form in numpy
    (:func:`galerkin_coarsen_host`; the levels hold numpy arrays until
    :meth:`Hierarchy.to`); ``"probe"`` probes with comb grids in torch
    (:func:`galerkin_coarsen`) on the fine operator's device, a CPU tensor
    copy of it where it is numpy.  The coarse inverse is a CPU tensor."""
    if method == "host":
        coarsen = galerkin_coarsen_host
    elif method == "probe":
        coarsen = galerkin_coarsen
        if isinstance(fine_op.coef, np.ndarray):
            fine_op = fine_op.to("cpu")
    else:
        raise ValueError(f'method must be "host" or "probe", got {method!r}')
    sizes = level_sizes(config, align=align, min_pad_level=min_pad_level)
    if sizes[0][0] != fine_op.n:
        raise ValueError(f"the fine operator has n={fine_op.n}, the config's "
                         f"finest level n={sizes[0][0]}")
    levels = [fine_op]
    for _, Sc in sizes[1:]:
        levels.append(coarsen(levels[-1], Sc))
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = coarse_dense_inverse(levels[-1])
    return Hierarchy(tuple(levels), coarse_inv)


def node_coordinates(n: int, S: int, dtype=torch.float32, device=None):
    """(x, y) coordinate grids of the (S, S) padded node array; h = 1/n."""
    idx = torch.arange(S, dtype=dtype, device=device) * (1.0 / n)
    x = idx[None, :].expand(S, S)
    y = idx[:, None].expand(S, S)
    return x, y
