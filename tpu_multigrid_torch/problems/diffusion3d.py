"""3D variable-coefficient diffusion -div(a grad u) + c u = f on the unit
cube, Dirichlet boundaries.

Per-cell coefficients ``a(x, y, z)`` give each level a 7-point flux stencil
with four-cell edge transmissibilities (``core.operators.
diffusion_op3_host``); the coarse levels re-discretize from 2x2x2 cell
averages.  An optional reaction term ``c`` (``shift``) joins every level's
diagonal as c h^2.  The hierarchy is built on the host in numpy, in the JAX
package's arithmetic, and put on the device in one upload.  Callables are
evaluated on float64 torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import numpy as np
import torch

from ..config import MultigridConfig, default_device
from ..core.grids import (Hierarchy, coarse_dense_inverse, level_sizes,
                          round_up)
from ..core.operators import VarStencilOp3D, diffusion_op3_host
from .poisson3d import poisson3d_rhs


def eval3(fn, shape, x, y, z) -> np.ndarray:
    """``fn`` (a constant or a callable) at the float64 coordinate tensors
    x, y, z (broadcastable to ``shape``), as a float64 numpy array."""
    if callable(fn):
        vals = torch.as_tensor(fn(x, y, z), dtype=torch.float64)
        return vals.expand(shape).numpy()
    return np.full(shape, float(fn), np.float64)


def axis_coordinates3(shape, n: int, offset: float = 0.0):
    """(x, y, z) float64 tensors (i + offset) h along each axis of ``shape``
    (z, y, x), broadcastable to it; h = 1/n."""
    h = 1.0 / n
    idx = (torch.arange(max(shape), dtype=torch.float64) + offset) * h
    return (idx[None, None, :shape[2]], idx[None, :shape[1], None],
            idx[:shape[0], None, None])


def cell_coefficients3(n: int, a: Union[float, Callable]) -> np.ndarray:
    """(n, n, n) float64 per-cell coefficients at the cell centres."""
    shape = (n, n, n)
    return eval3(a, shape, *axis_coordinates3(shape, n, 0.5))


def coarsen_cells3(cells: np.ndarray) -> np.ndarray:
    """2x2x2 arithmetic cell-average coarsening."""
    n = cells.shape[0]
    return cells.reshape(n // 2, 2, n // 2, 2, n // 2, 2).mean((1, 3, 5))


def _nodal_shift3(n: int, S: int, Sx: int, c, np_dt) -> np.ndarray:
    """(S, S, Sx) nodal ``c(x, y, z) * h^2``, zero outside the interior."""
    shape = (S, S, Sx)
    h = 1.0 / n
    vals = eval3(c, shape, *axis_coordinates3(shape, n))
    inter = np.zeros(shape, bool)
    inter[1:n, 1:n, 1:n] = True
    return np.where(inter, vals * h * h, 0.0).astype(np_dt)


def _with_shift3(op: VarStencilOp3D, c, np_dt) -> VarStencilOp3D:
    """Fold a reaction term c(x, y, z) u into a flux-stencil level: the
    nodal c h^2 joins the diagonal and inv_diag is rebuilt.  A shift that
    makes an interior diagonal non-positive raises: the solver supports the
    positive-definite regime only."""
    n, S, Sx = op.n, op.S, op.Sx
    c2 = _nodal_shift3(n, S, Sx, c, np_dt)
    tz, ty, tx = op.tz, op.ty, op.tx
    diag = (tx + np.roll(tx, 1, 2) + ty + np.roll(ty, 1, 1)
            + tz + np.roll(tz, 1, 0)).astype(np.float64) + c2
    if float(diag[1:n, 1:n, 1:n].min()) <= 0.0:
        raise ValueError("shift makes the 3D diagonal non-positive: the "
                         "operator leaves the positive-definite regime "
                         "this solver supports")
    inter = np.zeros((S, S, Sx), bool)
    inter[1:n, 1:n, 1:n] = True
    inv_diag = np.zeros((S, S, Sx), np.float64)
    inv_diag[inter] = 1.0 / diag[inter]
    del diag
    stack = np.empty((4, S, S, Sx), np_dt)
    stack[:3] = op.coef_stack
    stack[3] = c2
    return VarStencilOp3D(stack[0], stack[1], stack[2],
                          inv_diag.astype(np_dt), n, S, Sx, c2=stack[3],
                          t_minus=op.t_minus, coef_stack=stack)


def _np_dtype(dtype: torch.dtype):
    return np.dtype(str(dtype).replace("torch.", ""))


def build_diffusion3d_hierarchy(config: MultigridConfig, a, *, shift=0.0,
                                align: int = 16, min_pad_level: int = 0,
                                lane_align: int = 128) -> Hierarchy:
    """The re-discretized (S, S, Sx) hierarchy on the host, numpy arrays
    until :meth:`Hierarchy.to`; the coarse inverse (when the config asks for
    a direct coarsest solve) a CPU tensor."""
    sizes = level_sizes(config, align=align, min_pad_level=min_pad_level)
    np_dt = _np_dtype(config.dtype)
    cells = cell_coefficients3(2 ** config.finest_level, a)
    with_shift = callable(shift) or float(shift) != 0.0
    levels = []
    for n, S in sizes:
        Sx = round_up(n + 1, lane_align) if lane_align > 1 else S
        op = diffusion_op3_host(cells.astype(np_dt), n, S, Sx)
        if with_shift:
            op = _with_shift3(op, shift, np_dt)
        levels.append(op)
        if n > 2 ** config.coarsest_level:
            cells = coarsen_cells3(cells)
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = coarse_dense_inverse(levels[-1])
    return Hierarchy(tuple(levels), coarse_inv)


@dataclasses.dataclass
class Diffusion3DProblem:
    """Front-door 3D diffusion problem: hierarchy + right-hand side, on
    ``device`` (the card when None; see ``config.default_device``)."""

    config: MultigridConfig
    coefficient: Union[float, Callable] = 1.0
    forcing: Union[float, Callable] = 6.0
    shift: Union[float, Callable] = 0.0
    align: int = 16
    min_pad_level: int = 0
    lane_align: int = 128
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        self.device = default_device(self.device)
        hier = build_diffusion3d_hierarchy(
            self.config, self.coefficient, shift=self.shift,
            align=self.align, min_pad_level=self.min_pad_level,
            lane_align=self.lane_align)
        self.hierarchy: Hierarchy = hier.to(self.device)

    @property
    def finest(self):
        return self.hierarchy.levels[0]

    def rhs(self, level_index: int = 0, dtype=None) -> torch.Tensor:
        op = self.hierarchy.levels[level_index]
        dt = dtype if dtype is not None else self.config.dtype
        return poisson3d_rhs(op.n, op.grid_shape, self.forcing, dt,
                             self.device)

    def rhs_all_levels(self, dtype=None):
        return [self.rhs(k, dtype) for k in range(self.hierarchy.num_levels)]
