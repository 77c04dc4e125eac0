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
from .operators import ConstStencilOp, poisson_op


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


def coarse_dense_inverse(op: ConstStencilOp, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """Dense inverse of the interior operator, computed once in float64
    numpy and stored in ``dtype``."""
    if type(op) is not ConstStencilOp:
        raise NotImplementedError(
            f"coarse_dense_inverse supports ConstStencilOp only, got {op!r}")
    inv = np.linalg.inv(dense_poisson_matrix(op.n))
    return torch.as_tensor(inv, dtype=dtype, device=device)


def coarse_solve(op: ConstStencilOp, coarse_inv: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Direct coarsest-grid solve via the precomputed dense inverse."""
    inter = (slice(1, op.n), slice(1, op.n))
    rhs = b[inter].reshape(-1).to(coarse_inv.dtype)
    sol = torch.mv(coarse_inv, rhs).reshape(op.n - 1, op.n - 1).to(b.dtype)
    out = b.new_zeros((op.S, op.S))
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


def node_coordinates(n: int, S: int, dtype=torch.float32, device=None):
    """(x, y) coordinate grids of the (S, S) padded node array; h = 1/n."""
    idx = torch.arange(S, dtype=dtype, device=device) * (1.0 / n)
    x = idx[None, :].expand(S, S)
    y = idx[:, None].expand(S, S)
    return x, y
