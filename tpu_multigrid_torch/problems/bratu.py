"""Nonlinear Poisson problems with pointwise nonlinearities (FAS tier).

Canonical member: the Bratu problem −Δu − λ eᵘ = f on the unit square (or
cube) with homogeneous Dirichlet boundaries, the standard nonlinear-
multigrid test problem (solutions exist for λ below the critical value,
~6.81 on the unit square, ~9.9 on the unit cube).
:class:`NonlinearPoissonProblem` takes any pointwise φ(u): −Δu + φ(u) = f.

The discrete system is A u + h² φ(u) = h² f with the h-independent 5- or
7-point A; every level re-discretizes with its own h.  The counterpart of
``tpu_multigrid.problems.bratu``.  The Bratu problems carry φ as a
:class:`..core.nonlinear.BratuNonlinearity`, which the FAS kernels take;
a caller's own φ runs the plain path.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from ..config import MultigridConfig, default_device
from ..core.grids import (Hierarchy, dense_poisson_matrix, level_sizes,
                          round_up)
from ..core.nonlinear import BratuNonlinearity, PointwiseNonlinearOp
from ..core.operators import ConstStencilOp3D, poisson_op
from .poisson import poisson_rhs
from .poisson3d import poisson3d_rhs


def _a_dense(n, ndim, config, device):
    return torch.as_tensor(dense_poisson_matrix(n, ndim), dtype=config.dtype,
                           device=device)


def build_pointwise_hierarchy(config: MultigridConfig, phi: Callable,
                              dphi: Callable, *, align: int = 1,
                              min_pad_level: int = 99,
                              device=None) -> Hierarchy:
    """Per-level ``PointwiseNonlinearOp`` stack over the 5-point stencil.
    With ``coarse_solver="direct"`` the coarsest level carries the dense
    interior A (on ``device``) for the exact Newton coarse solve; with
    ``"smooth"`` FAS runs Jacobi–Newton sweeps there."""
    sizes = level_sizes(config, align=align, min_pad_level=min_pad_level)
    levels = []
    for idx, (n, S) in enumerate(sizes):
        a_dense = None
        if idx == len(sizes) - 1 and config.coarse_solver == "direct":
            a_dense = _a_dense(n, 2, config, device)
        levels.append(PointwiseNonlinearOp(poisson_op(n, S), phi, dphi,
                                           diag=4.0, a_dense=a_dense))
    return Hierarchy(tuple(levels), None)


def build_pointwise_hierarchy3(config: MultigridConfig, phi: Callable,
                               dphi: Callable, *, align: int = 1,
                               min_pad_level: int = 99, lane_align: int = 1,
                               device=None) -> Hierarchy:
    """3D per-level ``PointwiseNonlinearOp`` stack over the 7-point stencil
    (diag 6); the same coarsest Newton treatment as 2D.  Cubic (S, S, S)
    levels by default; the FAS kernels take the (S, S, Sx) layout of
    ``align=16, min_pad_level=0, lane_align=128``."""
    sizes = level_sizes(config, align=align, min_pad_level=min_pad_level)
    levels = []
    for idx, (n, S) in enumerate(sizes):
        a_dense = None
        if idx == len(sizes) - 1 and config.coarse_solver == "direct":
            a_dense = _a_dense(n, 3, config, device)
        Sx = round_up(n + 1, lane_align) if lane_align > 1 else S
        levels.append(PointwiseNonlinearOp(ConstStencilOp3D(n, S, Sx), phi,
                                           dphi, diag=6.0, a_dense=a_dense))
    return Hierarchy(tuple(levels), None)


@dataclasses.dataclass
class NonlinearPoissonProblem:
    """−Δu + φ(u) = f on the unit square, homogeneous Dirichlet boundaries,
    on ``device`` (the card when None; see ``config.default_device``)."""

    config: MultigridConfig
    phi: Callable = None
    dphi: Callable = None
    forcing: Union[float, Callable] = 4.0
    align: int = 1
    min_pad_level: int = 99
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        if self.phi is None or self.dphi is None:
            raise ValueError("NonlinearPoissonProblem needs phi and dphi")
        self.device = default_device(self.device)
        self.hierarchy: Hierarchy = build_pointwise_hierarchy(
            self.config, self.phi, self.dphi, align=self.align,
            min_pad_level=self.min_pad_level, device=self.device)

    @property
    def finest(self):
        return self.hierarchy.levels[0]

    def rhs(self, level_index: int = 0, dtype=None) -> torch.Tensor:
        op = self.hierarchy.levels[level_index]
        dt = dtype if dtype is not None else self.config.dtype
        return poisson_rhs(op.n, op.S, self.forcing, dt, self.device)

    def rhs_all_levels(self, dtype=None):
        return [self.rhs(k, dtype) for k in range(self.hierarchy.num_levels)]


@dataclasses.dataclass
class NonlinearPoisson3DProblem:
    """−Δu + φ(u) = f on the unit cube, homogeneous Dirichlet boundaries,
    on ``device`` (the card when None)."""

    config: MultigridConfig
    phi: Callable = None
    dphi: Callable = None
    forcing: Union[float, Callable] = 6.0
    align: int = 1
    min_pad_level: int = 99
    lane_align: int = 1
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        if self.phi is None or self.dphi is None:
            raise ValueError("NonlinearPoisson3DProblem needs phi and dphi")
        self.device = default_device(self.device)
        self.hierarchy: Hierarchy = build_pointwise_hierarchy3(
            self.config, self.phi, self.dphi, align=self.align,
            min_pad_level=self.min_pad_level, lane_align=self.lane_align,
            device=self.device)

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


def Bratu3DProblem(config: MultigridConfig, lam: float = 1.0,
                   forcing: Union[float, Callable] = 0.0, *,
                   align: int = 1, min_pad_level: int = 99,
                   lane_align: int = 1,
                   device=None) -> NonlinearPoisson3DProblem:
    """3D Bratu −Δu − λ eᵘ = f on the unit cube."""
    phi = BratuNonlinearity(lam)
    return NonlinearPoisson3DProblem(config, phi=phi, dphi=phi,
                                     forcing=forcing, align=align,
                                     min_pad_level=min_pad_level,
                                     lane_align=lane_align, device=device)


def BratuProblem(config: MultigridConfig, lam: float = 1.0,
                 forcing: Union[float, Callable] = 0.0, *, align: int = 1,
                 min_pad_level: int = 99,
                 device=None) -> NonlinearPoissonProblem:
    """Bratu problem −Δu − λ eᵘ = f (φ(u) = −λ eᵘ).  For f = 0 and λ below
    the critical value the Jacobi–Newton denominator 4 − λ h² eᵘ stays
    positive on the lower solution branch."""
    phi = BratuNonlinearity(lam)
    return NonlinearPoissonProblem(config, phi=phi, dphi=phi,
                                   forcing=forcing, align=align,
                                   min_pad_level=min_pad_level,
                                   device=device)
