"""3D Poisson problem on the unit cube, homogeneous Dirichlet boundaries.

-lap(u) = f on (0,1)^3 with the h-independent 7-point stencil and the
right-hand side ``f * h^2`` (``core.ops3d``).  The cycle drivers (V/W/F,
FMG, until-tol, refinement) walk 3D hierarchies as they walk 2D ones: the
transfers dispatch on the operator's ``ndim``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from ..config import MultigridConfig, default_device
from ..core import ops3d
from ..core.grids import (Hierarchy, coarse_dense_inverse, level_sizes,
                          round_up)
from ..core.operators import ConstStencilOp3D


def node_coordinates3(n: int, S, dtype=torch.float32, device=None):
    """(x, y, z) node coordinates on a padded (Sz, Sy, Sx) grid; h = 1/n."""
    shape = ops3d._shape3(S)

    def ax(size):
        return torch.arange(size, dtype=dtype, device=device) * (1.0 / n)

    x = ax(shape[2])[None, None, :].expand(shape)
    y = ax(shape[1])[None, :, None].expand(shape)
    z = ax(shape[0])[:, None, None].expand(shape)
    return x, y, z


def boundary_grid3(n: int, S, g: Union[float, Callable],
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """Padded grid holding the Dirichlet values ``g`` (a constant or
    ``g(x, y, z)``) on the six faces (any axis index in {0, n}) and zeros
    elsewhere, for lifting: u = w + G, A w = b - A G."""
    shape = ops3d._shape3(S)
    if callable(g):
        vals = g(*node_coordinates3(n, S, dtype, device)).to(dtype)
        vals = vals.expand(shape)
    else:
        vals = torch.full(shape, float(g), dtype=dtype, device=device)

    def ax_masks(size):
        i = torch.arange(size, device=device)
        return (i == 0) | (i == n), i <= n

    ez, rz = ax_masks(shape[0])
    ey, ry = ax_masks(shape[1])
    ex, rx = ax_masks(shape[2])
    in_rng = rz[:, None, None] & ry[None, :, None] & rx[None, None, :]
    on_face = ez[:, None, None] | ey[None, :, None] | ex[None, None, :]
    return torch.where(in_rng & on_face, vals, 0.0)


def poisson3d_rhs(n: int, S, f: Union[float, Callable] = 6.0,
                  dtype=torch.float32, device=None) -> torch.Tensor:
    """Padded right-hand side b = f(x, y, z) * h^2 on the interior; ``f`` a
    constant (6.0 by default) or a callable evaluated at the nodes."""
    shape = ops3d._shape3(S)
    h2 = (1.0 / n) ** 2
    if callable(f):
        vals = f(*node_coordinates3(n, shape, dtype, device)).to(dtype) * h2
    else:
        vals = torch.full(shape, float(f) * h2, dtype=dtype, device=device)
    return ops3d.mask_interior3(vals, n)


def build_poisson3d_hierarchy(config: MultigridConfig, *, align: int = 1,
                              min_pad_level: int = 0, lane_align: int = 1,
                              device=None) -> Hierarchy:
    """3D hierarchy of (S, S, Sx) levels: ``align`` pads z and y as
    :func:`level_sizes` does, ``lane_align`` pads the x side on its own (the
    front door takes 16 and 128, the layout the kernels' gates accept)."""
    sizes = level_sizes(config, align=align, min_pad_level=min_pad_level)
    levels = tuple(
        ConstStencilOp3D(n, S, round_up(n + 1, lane_align)
                         if lane_align > 1 else S)
        for n, S in sizes)
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = coarse_dense_inverse(levels[-1], device=device)
    return Hierarchy(levels, coarse_inv)


@dataclasses.dataclass
class Poisson3DProblem:
    """Front-door 3D problem object: hierarchy + per-level right-hand side,
    on ``device`` (the card when None; see ``config.default_device``)."""

    config: MultigridConfig
    forcing: Union[float, Callable] = 6.0
    align: int = 1
    min_pad_level: int = 99
    lane_align: int = 1
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        self.device = default_device(self.device)
        self.hierarchy: Hierarchy = build_poisson3d_hierarchy(
            self.config, align=self.align, min_pad_level=self.min_pad_level,
            lane_align=self.lane_align, device=self.device)

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
