"""Reaction-diffusion / shifted Poisson: -lap(u) + c u = f on the unit
square, Dirichlet boundaries.

In the h-independent FEM scaling the discrete operator is

    (4 + c(x) h^2) u_ij - sum(neighbours) = f h^2 ,

the Poisson stencil with the reaction folded into the diagonal.  Every level
re-discretizes with its own h.  The operators are :class:`VarStencilOp`, so
the variable-coefficient machinery (the var-stencil kernels, K1v/K2v, every
solve loop) applies unchanged.  A shift ``c >= 0`` only strengthens the
diagonal; this is not a solver for indefinite Helmholtz problems.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import numpy as np
import torch

from ..config import MultigridConfig, default_device
from ..core.grids import Hierarchy, coarse_dense_inverse, level_sizes
from ..core.operators import VarStencilOp
from .diffusion import upload
from .poisson import poisson_rhs

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _node_shift_values(n: int, S: int, c, dtype) -> np.ndarray:
    """(S, S) nodal c(x, y) values in numpy; a callable is evaluated on
    float64 CPU tensors of the node coordinates."""
    if callable(c):
        idx = torch.arange(S, dtype=torch.float64) * (1.0 / n)
        x = idx[None, :].expand(S, S)
        y = idx[:, None].expand(S, S)
        vals = torch.as_tensor(c(x, y), dtype=torch.float64).expand(S, S)
        return vals.numpy().astype(dtype)
    return np.full((S, S), float(c), dtype)


def helmholtz_op_host(n: int, S: int, c, dtype=np.float32) -> VarStencilOp:
    """5-point shifted-Poisson operator with diagonal 4 + c h² (host
    numpy)."""
    vals = _node_shift_values(n, S, c, dtype)
    h2 = np.asarray(1.0 / n, np.float64) ** 2
    diag = (4.0 + vals.astype(np.float64) * h2).astype(dtype)
    if float(diag[1:n, 1:n].min()) <= 0.0:
        raise ValueError(
            "shift makes the diagonal non-positive (4 + c h^2 <= 0): the "
            "operator is far outside the positive-definite regime this "
            "solver supports")
    coef = np.zeros((3, 3, S, S), dtype)
    interior = np.zeros((S, S), bool)
    interior[1:n, 1:n] = True
    coef[1, 1][interior] = diag[interior]
    for di, dj in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        coef[di + 1, dj + 1][interior] = -1.0
    inv_diag = np.zeros((S, S), dtype)
    inv_diag[interior] = 1.0 / diag[interior]
    return VarStencilOp(coef, inv_diag, n, S)


def build_helmholtz_hierarchy(config: MultigridConfig, c, *, align: int = 1,
                              min_pad_level: int = 99) -> Hierarchy:
    """Re-discretized hierarchy on the host: every level gets the diagonal
    4 + c h_l²."""
    sizes = level_sizes(config, align=align, min_pad_level=min_pad_level)
    np_dt = _NP_DTYPES[config.dtype]
    levels = tuple(helmholtz_op_host(n, S, c, np_dt) for n, S in sizes)
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = coarse_dense_inverse(levels[-1])
    return Hierarchy(levels, coarse_inv)


@dataclasses.dataclass
class HelmholtzProblem:
    """-lap(u) + c u = f, homogeneous Dirichlet boundaries, on ``device``
    (the card when None; see ``config.default_device``)."""

    config: MultigridConfig
    shift: Union[float, Callable] = 1.0
    forcing: Union[float, Callable] = 4.0
    align: int = 1
    min_pad_level: int = 99
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        self.device = default_device(self.device)
        hier = build_helmholtz_hierarchy(
            self.config, self.shift, align=self.align,
            min_pad_level=self.min_pad_level)
        self.hierarchy: Hierarchy = upload(hier, self.config, self.device)

    @property
    def finest(self):
        return self.hierarchy.levels[0]

    def rhs(self, level_index: int = 0, dtype=None) -> torch.Tensor:
        op = self.hierarchy.levels[level_index]
        dt = dtype if dtype is not None else self.config.dtype
        return poisson_rhs(op.n, op.S, self.forcing, dt, self.device)

    def rhs_all_levels(self, dtype=None):
        return [self.rhs(k, dtype) for k in range(self.hierarchy.num_levels)]
