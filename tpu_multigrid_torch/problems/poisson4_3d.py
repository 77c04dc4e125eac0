"""Fourth-order compact (Mehrstellen) Poisson in 3D.

The 19-point compact stencil

    (1/6) (24 u_0 - 2 sum_faces u - sum_edges u) = h^2 B f,
    B f = f + (1/12)(sum_faces f - 6 f)

is O(h^4)-accurate for -lap(u) = f with smooth f and still compact (one
ring), so every transfer and mask of the 7-point path holds unchanged.  It
is h-independent in this scaling: every level re-discretizes to the same
matrix-free stencil, :class:`core.operators.Const19Op`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from ..config import MultigridConfig, default_device
from ..core import ops3d
from ..core.grids import (Hierarchy, coarse_dense_inverse, level_sizes,
                          round_up)
from ..core.operators import Const19Op


def mehrstellen_rhs3(n: int, grid_shape, forcing: Union[float, Callable],
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """Right-hand side ``h^2 B f`` with ``B = I + (faces - 6 I)/12``; for a
    constant f, B f = f (unit row sum)."""
    h2 = (1.0 / n) ** 2
    Sz, Sy, Sx = grid_shape
    if callable(forcing):
        idx = torch.arange(max(Sz, Sy, Sx), dtype=dtype,
                           device=device) * (1.0 / n)
        f = forcing(idx[None, None, :Sx], idx[None, :Sy, None],
                    idx[:Sz, None, None]).expand(grid_shape).to(dtype)
        faces = (torch.roll(f, 1, -3) + torch.roll(f, -1, -3)
                 + torch.roll(f, 1, -2) + torch.roll(f, -1, -2)
                 + torch.roll(f, 1, -1) + torch.roll(f, -1, -1))
        vals = (f + (faces - 6.0 * f) / 12.0) * h2
    else:
        vals = torch.full(grid_shape, float(forcing) * h2, dtype=dtype,
                          device=device)
    return ops3d.mask_interior3(vals, n)


def build_mehrstellen3_hierarchy(config: MultigridConfig, *, align: int = 1,
                                 min_pad_level: int = 99, lane_align: int = 1,
                                 device=None) -> Hierarchy:
    """19-point levels, cubic by default; the level-visit kernels take
    ``align=16, min_pad_level=0, lane_align=128``.  The coarse inverse is
    probed through ``Const19Op.apply``."""
    sizes = level_sizes(config, align=align, min_pad_level=min_pad_level)
    levels = tuple(
        Const19Op(n, S, round_up(n + 1, lane_align) if lane_align > 1 else S)
        for n, S in sizes)
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = coarse_dense_inverse(levels[-1], device=device)
    return Hierarchy(levels, coarse_inv)


@dataclasses.dataclass
class Poisson4_3DProblem:
    """-lap(u) = forcing on the unit cube at fourth order, on ``device`` (the
    card when None)."""

    config: MultigridConfig
    forcing: Union[float, Callable] = 6.0
    align: int = 1
    min_pad_level: int = 99
    lane_align: int = 1
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        self.device = default_device(self.device)
        self.hierarchy: Hierarchy = build_mehrstellen3_hierarchy(
            self.config, align=self.align, min_pad_level=self.min_pad_level,
            lane_align=self.lane_align, device=self.device)

    @property
    def finest(self):
        return self.hierarchy.levels[0]

    def rhs(self, dtype=None) -> torch.Tensor:
        op = self.finest
        dt = dtype if dtype is not None else self.config.dtype
        return mehrstellen_rhs3(op.n, op.grid_shape, self.forcing, dt,
                                self.device)
