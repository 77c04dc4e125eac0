"""Quasilinear diffusion −∇·(a(u)∇u) = f on the unit square or cube (FAS
tier).

The default coefficient is a(u) = 1 + γu², a
:class:`..core.nonlinear.QuadraticCoefficient`, which the FAS kernels take;
a caller's own positive a(u) runs the plain path.  Matrix-free flux
discretization (:class:`..core.nonlinear.QuasilinearFluxOp`): edge
coefficients are evaluated at solution midpoints on every application, so
there are no stored coefficient planes and every level re-discretizes.
The counterpart of ``tpu_multigrid.problems.nldiffusion``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from ..config import MultigridConfig, default_device
from ..core.grids import Hierarchy, level_sizes, round_up
from ..core.nonlinear import (QuadraticCoefficient, QuasilinearFluxOp,
                              QuasilinearFluxOp3)
from .poisson import poisson_rhs
from .poisson3d import poisson3d_rhs


def build_quasilinear_hierarchy(config: MultigridConfig, a: Callable,
                                da: Callable, *, align: int = 1,
                                min_pad_level: int = 99) -> Hierarchy:
    sizes = level_sizes(config, align=align, min_pad_level=min_pad_level)
    levels = tuple(QuasilinearFluxOp(n, S, a, da) for n, S in sizes)
    return Hierarchy(levels, None)


def build_quasilinear_hierarchy3(config: MultigridConfig, a: Callable,
                                 da: Callable, *, align: int = 1,
                                 min_pad_level: int = 99,
                                 lane_align: int = 1) -> Hierarchy:
    """3D quasilinear flux stack: cubic (S, S, S) levels by default, or the
    (S, S, Sx) layout the FAS kernels take (see
    ``bratu.build_pointwise_hierarchy3``)."""
    sizes = level_sizes(config, align=align, min_pad_level=min_pad_level)
    levels = tuple(
        QuasilinearFluxOp3(n, S, a, da,
                           round_up(n + 1, lane_align) if lane_align > 1
                           else S)
        for n, S in sizes)
    return Hierarchy(levels, None)


def _default_coefficient(problem) -> None:
    if problem.a is None:
        problem.a = QuadraticCoefficient(problem.gamma)
        problem.da = problem.a.da


@dataclasses.dataclass
class QuasilinearDiffusion3DProblem:
    """−∇·(a(u)∇u) = f on the unit cube; default a = 1 + γu².  The coarsest
    level is solved by Picard–Jacobi sweeps; on ``device`` (the card when
    None)."""

    config: MultigridConfig
    gamma: float = 1.0
    a: Callable = None
    da: Callable = None
    forcing: Union[float, Callable] = 6.0
    align: int = 1
    min_pad_level: int = 99
    lane_align: int = 1
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        _default_coefficient(self)
        self.device = default_device(self.device)
        self.hierarchy: Hierarchy = build_quasilinear_hierarchy3(
            self.config, self.a, self.da, align=self.align,
            min_pad_level=self.min_pad_level, lane_align=self.lane_align)

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


@dataclasses.dataclass
class QuasilinearDiffusionProblem:
    """−∇·(a(u)∇u) = f, homogeneous Dirichlet boundaries; default a = 1 +
    γu².  The coarsest FAS level is solved by Picard–Jacobi sweeps
    (``config.coarse_smooth_sweeps``: the operator has no constant dense
    form); on ``device`` (the card when None)."""

    config: MultigridConfig
    gamma: float = 1.0
    a: Callable = None
    da: Callable = None
    forcing: Union[float, Callable] = 4.0
    align: int = 1
    min_pad_level: int = 99
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        _default_coefficient(self)
        self.device = default_device(self.device)
        self.hierarchy: Hierarchy = build_quasilinear_hierarchy(
            self.config, self.a, self.da, align=self.align,
            min_pad_level=self.min_pad_level)

    @property
    def finest(self):
        return self.hierarchy.levels[0]

    def rhs(self, level_index: int = 0, dtype=None) -> torch.Tensor:
        op = self.hierarchy.levels[level_index]
        dt = dtype if dtype is not None else self.config.dtype
        return poisson_rhs(op.n, op.S, self.forcing, dt, self.device)

    def rhs_all_levels(self, dtype=None):
        return [self.rhs(k, dtype) for k in range(self.hierarchy.num_levels)]
